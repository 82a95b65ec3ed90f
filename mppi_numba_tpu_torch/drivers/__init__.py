"""The port's measurement drivers: the counterparts of the JAX package's
``bench.py``, ``scripts/*_bench.py`` / ``scripts/profile_flagship.py`` and
``scripts/run_full_benchmark.py`` / ``scripts/engine_ab_check.py``, which
stay JAX-only.  Each runs as a module on a card (``--device cpu`` on
request) and prints the card's name and power limit, then JSON lines under
the JAX script's scenario names and keys:

    python -m mppi_numba_tpu_torch.drivers.bench             # bench.py
    python -m mppi_numba_tpu_torch.drivers.bigmap_bench      # realistic maps
    python -m mppi_numba_tpu_torch.drivers.model_bench       # barebone, bicycle, K = 10240
    python -m mppi_numba_tpu_torch.drivers.serve_bench       # batched episodes
    python -m mppi_numba_tpu_torch.drivers.profile_flagship  # stage by stage
    torchrun --nproc-per-node N -m mppi_numba_tpu_torch.drivers.scaling_bench
    python -m mppi_numba_tpu_torch.drivers.full_benchmark    # the reference protocol
    python -m mppi_numba_tpu_torch.drivers.engine_ab_check   # host vs device engine

Each keeps its own copy of its JAX script's problem builder.  Times are on
the device clock where the solve replays from a CUDA graph
(``profiling.chained_solve_time``), and labelled eager or host-clock where
it does not.
"""
