from .kernel import flash_decode_bshd, flash_decode_paged_bshd
from .ops import decode_attention, decode_attention_paged
from .ref import (decode_attention_paged_ref, decode_attention_ref,
                  pool_from_contiguous)
