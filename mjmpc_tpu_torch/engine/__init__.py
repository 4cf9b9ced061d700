from . import chain
from .chain import ChainModel, build_chain

__all__ = ["chain", "ChainModel", "build_chain"]
