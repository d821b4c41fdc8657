#!/usr/bin/env python3
"""Which of K2's launches a ``torch.profiler`` window records.

    python3 tools/profile_window.py

Builds the all-to-all kernel (K2, ``spark_tpu_torch/csrc/all_to_all.cu``)
and launches it at the shape of the largest exchange of ``chip_smoke.py``'s
mesh phase (4 participants; three int32, two int64 and one bool plane of
4 x 2^24 elements per sender), inside profiles that differ in how the
window is laid out:

* ``plain`` — idle pad, 5 launches, synchronize, idle pad (the window
  ``chip_smoke.kernel_device_ms`` used);
* ``marked`` — a one-element fill (the marker) before each launch and
  after the last one, so every record's place in the sequence shows;
* ``lead`` / ``tail`` — one marker before the first launch / after the
  last launch only;
* ``long_tail`` — the plain window with a 0.5 s idle pad at its end.

For each profile it prints the device records in order of their start
(``K`` = K2, ``m`` = marker, ``?`` = anything else) and K2's count.
Prints the card's name and power limit first.  Needs a GPU and
``nvcc``; imports neither JAX nor the JAX package.
"""

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PAD_S = 0.05
REPS = 5
TRIES = 3


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _random_planes
    from spark_tpu_torch import cuda_a2a

    if not torch.cuda.is_available():
        print("profile_window: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    i32, i64, b8 = torch.int32, torch.int64, torch.bool
    cap = 1 << 24
    planes = _random_planes(4, [(i32, (cap,))] * 3 + [(i64, (cap,))] * 2
                            + [(b8, (cap,))], 7)
    marker = torch.zeros(1, device="cuda")

    def k2():
        cuda_a2a.all_to_all(planes)

    def mark():
        marker.fill_(1.0)

    k2()
    mark()
    torch.cuda.synchronize()

    def layout(kind):
        if kind in ("marked", "lead"):
            mark()
        for i in range(REPS):
            k2()
            if kind == "marked":
                mark()
        if kind == "tail":
            mark()

    for kind in ("plain", "marked", "lead", "tail", "long_tail"):
        for attempt in range(TRIES):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(PAD_S)
                layout(kind)
                torch.cuda.synchronize()
                time.sleep(0.5 if kind == "long_tail" else PAD_S)
            recs = sorted((e.time_range.start, e.name) for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA)
            seq = "".join("K" if "all_to_all_kernel" in n else
                          "m" if "fill" in n.lower() or "Fill" in n else "?"
                          for _t, n in recs)
            others = sorted({n for _t, n in recs
                             if "all_to_all_kernel" not in n})
            print(f"[window] {kind} try {attempt}: K2 records "
                  f"{seq.count('K')} of {REPS}; sequence {seq}; other "
                  f"records {others}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
