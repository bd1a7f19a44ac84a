from .kernel import flash_attention_bshd
from .ops import attention
from .ref import attention_ref, attention_xla
