"""Parallel layers of the port. So far one device: `full_attention` and
the transformer LM (`transformer`); the mesh, collectives and the ring
across devices come with the multi-GPU slice."""
from .ring_attention import full_attention

__all__ = ['full_attention']
