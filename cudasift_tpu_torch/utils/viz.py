"""Match visualization, the analogue of ``PrintMatchData``
(mainSift.cpp:150-200): draw match displacement lines and keypoint boxes
into a grayscale image. Host code on numpy copies of the fields."""

from __future__ import annotations

import numpy as np

from ..sift_data import SiftData


def draw_match_data(data1: SiftData, data2: SiftData, img: np.ndarray,
                    error_limit: float = 5.0) -> np.ndarray:
    """Return a copy of ``img`` with match lines (white) and scale boxes
    (white-over-black crosses) burned in, as the reference demo does."""
    out = np.asarray(img, np.float32).copy()
    h, w = out.shape
    n = int(data1.num_pts)
    x1 = data1.xpos[:n].cpu().numpy()
    y1 = data1.ypos[:n].cpu().numpy()
    sc = data1.scale[:n].cpu().numpy()
    match = data1.match[:n].cpu().numpy()
    err = data1.match_error[:n].cpu().numpy()
    x2 = data2.xpos.cpu().numpy()
    y2 = data2.ypos.cpu().numpy()

    for j in range(n):
        k = match[j]
        if 0 <= k < x2.shape[0] and err[j] < error_limit:
            dx = x2[k] - x1[j]
            dy = y2[k] - y1[j]
            length = int(max(abs(dx), abs(dy)))
            for l in range(length):
                x = int(x1[j] + dx * l / length)
                y = int(y1[j] + dy * l / length)
                if 0 <= x < w and 0 <= y < h:
                    out[y, x] = 255.0
        x = int(x1[j] + 0.5)
        y = int(y1[j] + 0.5)
        s = int(min(x, y, w - x - 2, h - y - 2, int(1.41 * sc[j])))
        if s <= 0:
            continue
        for k in range(s):
            # black cross shifted by (1,1), white cross at the point
            out[y + 1, max(x + 1 - k, 0)] = out[y + 1, min(x + 1 + k, w - 1)] = 0.0
            out[max(y + 1 - k, 0), x + 1] = out[min(y + 1 + k, h - 1), x + 1] = 0.0
        for k in range(s):
            out[y, max(x - k, 0)] = out[y, min(x + k, w - 1)] = 255.0
            out[max(y - k, 0), x] = out[min(y + k, h - 1), x] = 255.0
    return out
