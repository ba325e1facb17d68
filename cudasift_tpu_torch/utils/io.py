"""Image I/O, the replacement for the reference's OpenCV loading path
(mainSift.cpp:35-41 reads PGM/PNG via cv::imread).

A dependency-free PGM reader (binary P5 and ASCII P2) and binary P5 writer,
as in the JAX package; other formats go through OpenCV or PIL when one is
installed. The C++ codec of ``utils/native.py`` reads and writes the same
files.
"""

from __future__ import annotations

import numpy as np


def read_pgm(path: str) -> np.ndarray:
    """Read a binary (P5) or ASCII (P2) PGM into float32 (H, W)."""
    with open(path, "rb") as f:
        data = f.read()
    # Header: magic, width, height, maxval -- whitespace/comment separated.
    tokens = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
            continue
        start = i
        while i < len(data) and not data[i : i + 1].isspace():
            i += 1
        tokens.append(data[start:i])
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic == b"P5":
        i += 1  # single whitespace after maxval
        dtype = np.uint8 if maxval < 256 else ">u2"
        img = np.frombuffer(data, dtype=dtype, count=w * h, offset=i)
        return img.reshape(h, w).astype(np.float32)
    if magic == b"P2":
        vals = np.array(data[i:].split(), dtype=np.float32)[: w * h]
        return vals.reshape(h, w)
    raise ValueError(f"unsupported PGM magic {magic!r} in {path}")


def write_pgm(path: str, img: np.ndarray) -> None:
    """Write a float/int array as binary P5 PGM (clipped to 0..255)."""
    arr = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    h, w = arr.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(arr.tobytes())


def imread_gray(path: str) -> np.ndarray:
    """Load any image as float32 grayscale; PGM natively, else cv2/PIL."""
    if path.lower().endswith(".pgm"):
        return read_pgm(path)
    try:
        import cv2

        img = cv2.imread(path, 0)
        if img is None:
            raise FileNotFoundError(path)
        return img.astype(np.float32)
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"), np.float32)
