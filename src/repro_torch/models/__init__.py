from .api import Model, build_model, grow_cache, resolve_device
