"""Quickstart on the PyTorch port: integral histogram -> O(1) region
queries -> search.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The twin of ``examples/quickstart.py``, with the same stages plus
``--device`` (the GPU unless ``cpu`` or another torch device is named):
WF-TiS computes H (K1 on the card), a region histogram is read off it
in O(1), and a multi-scale exhaustive search finds the window most
similar to a 64x64 template.  ``main(argv)`` returns what it prints.
"""

import argparse

import torch

from repro_torch.core import distances
from repro_torch.core.integral_histogram import IntegralHistogram
from repro_torch.core.region_query import multi_scale_search, region_histogram
from repro_torch.data import video_frames
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; the GPU when not given")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # one synthetic 480p frame
    frame = torch.as_tensor(video_frames(480, 640, 1, seed=7)[0], device=dev)

    # 1. the paper's data structure: H(b, x, y), here via the WF-TiS method
    ih = IntegralHistogram(num_bins=32, method="wf_tis", backend="auto",
                           device=str(dev))
    H = ih(frame)
    print(f"integral histogram: {tuple(H.shape)}  "
          f"({H.numel() * H.element_size() / 2**20:.1f} MiB)")

    # 2. O(1) region histogram (paper Eq. 2): any rectangle, constant time
    hist = region_histogram(H, [100, 150, 199, 279])
    region_sum = float(hist.sum())
    print(f"region [100:200, 150:280] histogram sum = {region_sum} "
          f"(area = {100*130})")

    # 3. constant-time exhaustive search: find the window most similar to a
    #    template histogram at every stride-8 position
    target = region_histogram(H, [200, 300, 263, 363])        # 64x64 patch
    rect, score, _ = multi_scale_search(
        H, target, windows=((64, 64), (80, 80)),
        metric=distances.intersection, stride=8)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rect = [int(v) for v in rect.cpu()]
    print(f"best match rect={rect} score={float(score):.3f}")
    return {"H_shape": tuple(H.shape), "region_sum": region_sum,
            "best_rect": rect, "score": float(score)}


if __name__ == "__main__":
    main()
