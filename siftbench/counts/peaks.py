"""Published peaks of one NVIDIA H100 SXM at its full 700 W limit (NVIDIA's
data sheet; dense rates): device memory bytes/s, and operations/s by type.
A card set below 700 W runs slower under load: a run prints the card's limit
beside these."""

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}


def bound_s(ops: float, nbytes: float, kind: str = "f32") -> tuple[float, str]:
    """The least time (s) the card could take: the larger of ``nbytes`` over
    the memory rate and ``ops`` over the peak rate of ``kind``, and which of
    the two sets it."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[kind]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
