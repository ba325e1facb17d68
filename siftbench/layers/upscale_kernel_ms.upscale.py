"""Device time a frame of the ScaleUp kernel (``csrc/scale_up.cu``) over the
profiled stretch. None where the kernel did not run (a program without it).

A time and not a share of the kernel's roofline: its 19.7 MB output at
1280x960 fits in the card's 50 MB L2, whose write-back to device memory
lands in the kernels after it, so the kernel alone runs under the device
memory bound (counts/scale_up.py) and a share of it would read over 100%."""

NAME = "upscale_kernel_ms.upscale"
UNIT = "ms"
LAYER = "hand-written kernels (csrc/)"
SOURCE = "device_trace"
KERNEL = "scale_up_kernel"


def read(reading):
    p = reading.profile
    frames = p.calls.get("extract_sift", 0) if p is not None else 0
    seconds = p.kernel_s(lambda n: KERNEL in n) if frames else 0.0
    return 1e3 * seconds / frames if seconds > 0 else None
