"""Published peaks of the card the benchmark runs on.

NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, dense rates, at its 700 W
limit): HBM3 at 3.35 TB/s; NVLink 4 at 900 GB/s per card in both
directions together, 450 GB/s each way.  A roofline share is the least
time these allow for the work, over the time measured; the card's
power limit is printed beside every run.
"""

HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9          # one direction, one card
