"""train_mfu: the training step's model FLOPs (``counts.model_flops``)
times the steps of the traced slice, over the slice's time, as a share
of the float32 peak (TF32 stays off)."""

from benchmark import counts, peaks


def read(s: dict):
    if not s.get("train") or not s.get("steps") or not s.get("window_s"):
        return None
    flops = counts.model_flops(s["shape"], s["batch"], True) * s["steps"]
    return 100.0 * flops / s["window_s"] / peaks.FP32_FLOPS_PER_S
