from .kernel import wkv6_chunked_bshk
from .ops import wkv6, wkv6_decode
from .ref import wkv6_chunked, wkv6_decode_ref, wkv6_scan_ref
