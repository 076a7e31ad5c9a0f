"""setup_graph_s: the program's stage ``setup.graph`` (coalescing, the
undirected graph, degrees and RA in ``build_link_dataset``), its self
seconds in the run's set-up (``benchmark/spans.py``)."""

from benchmark import spans

measure = spans.measure


def read(s: dict):
    return spans.stage_s(s, "setup.graph")
