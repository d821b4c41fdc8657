"""Repo-wide pytest bootstrap, loaded before tests/conftest.py.

XLA's CPU AOT loader logs a ~2 KB ERROR line for every executable it
loads from the persistent compilation cache (a spurious target-feature
mismatch on the tuning flags +prefer-no-gather/+prefer-no-scatter). The
multi-process tests spawn their workers with output on a pipe that is
read only after a peer exits; once the cache is warm, a worker fills its
pipe with those lines and blocks, and its peer waits on it at the next
exchange until the test times out. Keep XLA's C++ logging to FATAL in the
test process, and so in every worker it spawns.
"""

import os

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
