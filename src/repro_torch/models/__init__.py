from .api import (Model, PagedArena, build_model, grow_cache,
                  paged_init_pool, paged_supported, resolve_device)
