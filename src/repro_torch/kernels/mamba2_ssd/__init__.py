from .kernel import ssd_chunked_bshp
from .ops import ssd, ssd_decode
from .ref import ssd_chunked, ssd_decode_ref, ssd_scan_ref
