"""Native host runtime: the C++ radix sort and the C++ CSV loader, built on
demand with g++ (``_gxx.py``). Counterpart of ``radix_sort_tpu/native``."""

from radix_sort_tpu_torch.native.host import (
    host_sort,
    host_sort_pairs,
    native_available,
)

__all__ = ["host_sort", "host_sort_pairs", "native_available"]
