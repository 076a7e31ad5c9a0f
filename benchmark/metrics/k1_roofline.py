"""k1_roofline: kernel K1's float32 add in the traced slice of ELPH
training.  Its bytes come from the staged plans' shapes by the kernel
table's formula (``counts.k1_add_bytes``): per step one forward and one
backward SpMM a hop and one row-gather backward, held against the
program's ``launches`` counter; its time is the trace's ``segscan`` and
``carry`` kernels.  Nothing to read where the counter or the trace does
not show exactly those launches (a trace that lost kernels)."""

from benchmark import counts, peaks


def read(s: dict):
    plan, shape = s.get("plan"), s.get("shape", {})
    steps = s.get("steps")
    if not plan or not steps or "nnz" not in shape:
        return None
    per_step = 2 * shape["hops"] + 1
    launched = s.get("k1_launches", {}).get("segscan_add_f32", 0)
    traced = sum(c for n, c in s["kernel_n"].items()
                 if "segscan_kernel" in n)
    if launched != per_step * steps or traced != launched:
        return None
    w, n = shape["hidden"], plan["nodes"]
    nbytes = shape["hops"] * (
        counts.k1_add_bytes(plan["fwd_subruns"], n, w)
        + counts.k1_add_bytes(plan["bwd_subruns"], n, w)) \
        + counts.k1_add_bytes(2 * s["batch"], n, w)
    seconds = sum(t for k, t in s["kernel_s"].items()
                  if "segscan_kernel" in k or "carry_kernel" in k)
    if seconds <= 0:
        return None
    return 100.0 * nbytes * steps / peaks.HBM_BYTES_PER_S / seconds
