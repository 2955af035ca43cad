from .stream import TokenStream

__all__ = ["TokenStream"]
