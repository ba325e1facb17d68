"""K1's share of its roofline: the least time the card needs for a frame's
blurs, DoG and extremum mask (counts/dog.py) over K1's device time a frame."""

NAME = "dog_roofline.frames"
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
    bound, _ = reading.registry.count("dog").bound_s(frame["height"], frame["width"],
                                                     sift["num_octaves"])
    return 100.0 * bound * frames / seconds
