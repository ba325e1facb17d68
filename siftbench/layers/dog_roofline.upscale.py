"""K1's share of its roofline in a cell whose configuration sets
``scale_up``: the least time the card needs for the blurs, DoG and extremum
mask of the pyramid built on the upsampled frame (counts/dog.py at twice the
frame's height and width) over K1's device time a frame."""

NAME = "dog_roofline.upscale"
UNIT = "%"
LAYER = "hand-written kernels (csrc/)"
SOURCE = "device_trace"
KERNEL = "dog_and_mask_kernel"


def read(reading):
    p = reading.profile
    frames = p.calls.get("extract_sift", 0) if p is not None else 0
    seconds = p.kernel_s(lambda n: KERNEL in n) if frames else 0.0
    if seconds <= 0:
        return None
    frame, sift = reading.cfg["frame"], reading.cfg["sift"]
    up = 2 if sift.get("scale_up", False) else 1
    bound, _ = reading.registry.count("dog").bound_s(up * frame["height"], up * frame["width"],
                                                     sift["num_octaves"])
    return 100.0 * bound * frames / seconds
