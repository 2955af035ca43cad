from .checkpoint import (load_cache, load_kvstore, load_pytree, save_cache,
                         save_kvstore, save_pytree)

__all__ = ["load_pytree", "save_pytree", "save_kvstore", "load_kvstore",
           "save_cache", "load_cache"]
