"""Counterparts of the JAX repository's command-line tools (``tools/``).

Each runs as ``python -m subgraph_sketching_tpu_torch.tools.<name>``, on
the card unless ``--device cpu`` (or ``--platform cpu``) is given, and
raises where there is no card:

  * ``citation2_train``: BUDDY end to end at citation2 scale (a
    2,927,963-node graph, 30M links), stage by stage;
  * ``repro_baseline``: the reference README's commands through the
    port's runner, where their datasets are on disk (the real-data gate);
  * ``run_protocol``: the 10-rep leaderboard protocol on the bundled
    graphs;
  * ``scale_equality``: the memory-sharded paths (node-sharded BUDDY
    preprocessing, memory-sharded ELPH) at production scale against one
    process, their ranks sharing one card;
  * ``gen_hll_tables``: the HLL++ bias tables the estimator reads.

The two quality tools write ``QUALITY_torch_r<NN>.json`` in the working
directory, never the JAX package's ``QUALITY_r<NN>.json`` record;
``gen_hll_tables`` writes ``hll_tables_torch.npz`` there, never the
committed ``sketch/_hll_tables.npz``, and ``scale_equality`` its report
only where its ``out.json`` argument says.
"""
