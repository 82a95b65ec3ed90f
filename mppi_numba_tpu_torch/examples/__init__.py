"""The port's examples: the counterparts of the JAX package's
``examples/*.py``, which stay its own surfaces.  Each runs as a module on
a card (``--device cpu`` on request; ``--small`` for a quick run), prints
the card's name and power limit, then JSON lines (what runs, and the
outcome with its solve times, kernel launches and CUDA graphs), and draws
its figures only where matplotlib imports, into ``--out-dir`` (default
``build/examples_torch/``), never into ``examples/``:

    python -m mppi_numba_tpu_torch.examples.barebone_mppi
    python -m mppi_numba_tpu_torch.examples.terrain_planning [tdm|det|speed]
    python -m mppi_numba_tpu_torch.examples.external_pmf_planning
    python -m mppi_numba_tpu_torch.examples.costmap_planning
    python -m mppi_numba_tpu_torch.examples.confidence_planning [conf_thres] [tdm_models_dir] [--gif | --gt-nn]
    python -m mppi_numba_tpu_torch.examples.planner_animation [tdm|det|speed|example] [alpha]

Each keeps its own copy of what its script synthesises, and a ``build``
that returns the configuration, the params, the planner set up on its
TDMs and the ground truth.
"""
