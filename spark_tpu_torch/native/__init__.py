"""Host kernels of the port.

The reference (``spark_tpu/native/``) compiles a C++ library with a
numpy lane beside it.  Here the sketches (``BloomFilter``,
``CountMinSketch``, ``murmur3_hash_long``) run through the port's own
C++ source (``src/sketch.cpp``), compiled with ``g++`` into ``build/``
at first use; a failed build raises.  The out-of-core runners' merge and
partition are numpy, with the same permutations as the reference's C++
ones (a stable merge of sorted runs, a stable counting sort by bucket).
"""

from .build import load_library                         # noqa: F401
from .merge import merge_sorted_runs                    # noqa: F401
from .partition import partition_permutation            # noqa: F401
from .sketch import (BloomFilter, CountMinSketch,       # noqa: F401
                     murmur3_hash_long)
