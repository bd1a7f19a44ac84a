from .kernel import flash_decode_bshd
from .ops import decode_attention
from .ref import decode_attention_ref
