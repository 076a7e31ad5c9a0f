"""Counterparts of the JAX repository's command-line tools (``tools/``).

Each runs as ``python -m subgraph_sketching_tpu_torch.tools.<name>``, on
the card unless ``--device cpu`` (or ``--platform cpu``) is given, and
raises where there is no card:

  * ``citation2_train``: BUDDY end to end at citation2 scale (a
    2,927,963-node graph, 30M links), stage by stage;
  * ``repro_baseline``: the reference README's commands through the
    port's runner, where their datasets are on disk (the real-data gate);
  * ``run_protocol``: the 10-rep leaderboard protocol on the bundled
    graphs.

The two quality tools write ``QUALITY_torch_r<NN>.json`` in the working
directory, never the JAX package's ``QUALITY_r<NN>.json`` record.
"""
