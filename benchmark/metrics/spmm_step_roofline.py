"""spmm_step_roofline: the GCN's ``PlanSpmm`` passes inside the training
steps, by the program's spans ``spmm.forward`` and ``spmm.backward`` (whole
passes, K1 included, each on the device's clock): the least bytes a pass
needs at the cell's graph and hidden width (``counts.spmm_pass_bytes``, as
``spmm_roofline`` counts them) times the passes recorded, at the HBM rate,
over their device seconds.  Nothing to read where the program recorded no
pass."""

from benchmark import counts, peaks, spans

measure = spans.measure


def read(s: dict):
    got = s.get("program_spans") or {}
    shape = s.get("shape", {})
    passes = [got[n] for n in ("spmm.forward", "spmm.backward") if n in got]
    if not passes or "nnz" not in shape:
        return None
    seconds = sum(p["device_s"] for p in passes)
    if seconds <= 0:
        return None
    nbytes = counts.spmm_pass_bytes(shape["nodes"], shape["nnz"],
                                    shape["hidden"])
    return 100.0 * nbytes * sum(p["count"] for p in passes) \
        / peaks.HBM_BYTES_PER_S / seconds
