"""The benchmark's cells cut to a size a CPU test holds: every width and
rule of the configuration kept but the hidden width, the graph's scale
and the batch."""

from benchmark import spec

TINY = {
    "elph-collab": dict(graph=dict(nodes=300, edges=1500, features=16),
                        config=dict(hidden_channels=32, batch_size=64)),
    "buddy-citation2": dict(graph=dict(nodes=400, edges=2000, features=16),
                            config=dict(hidden_channels=16, batch_size=128),
                            supervision=dict(count=200)),
}


def tiny_cell(name: str):
    cell = spec.find_cell(name)
    for key, value in TINY[cell.config["name"]].items():
        cell.config[key] = dict(cell.config[key], **value)
    cell.mix = dict(cell.mix, trace_seconds=0.2)
    return cell
