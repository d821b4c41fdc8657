"""Host kernels of the out-of-core runners, in numpy.

The reference (``spark_tpu/native/``) compiles a C++ library with a
numpy lane beside it; these are the numpy lane, which gives the same
permutations as the C++ one (a stable merge of sorted runs, a stable
counting sort by bucket).  The sketches of the reference
(``BloomFilter``, ``CountMinSketch``) come with the next slice.
"""

from .merge import merge_sorted_runs                    # noqa: F401
from .partition import partition_permutation            # noqa: F401
