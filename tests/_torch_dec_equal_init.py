"""A user program written for the JAX package: examples/dec/dec.py's
quick run with every weight Xavier would draw taken from numpy instead
(a normal of variance 2 / fan-in, seeded by the parameter's name), so
that the two packages start from the same weights.

`run(seed)` returns {'accuracy': [k-means init, DEC final]}.
tests/test_torch_examples.py runs it on the JAX package in its own
process and on the port in a child interpreter
(tests/_torch_examples_child.py), and compares the two.
"""
import importlib.util
import os
import zlib

import numpy as np

import mxnet_tpu as mx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _numpy_init(seed):
    def init(self, desc, arr):
        name = str(desc)
        if name.endswith('bias'):
            value = np.zeros(arr.shape, np.float32)
        else:
            rs = np.random.RandomState(zlib.crc32(name.encode()) + seed)
            value = (rs.randn(*arr.shape) *
                     np.sqrt(2.0 / arr.shape[-1])).astype(np.float32)
        arr[:] = mx.nd.array(value, ctx=arr.context)
    return init


def run(seed):
    spec = importlib.util.spec_from_file_location(
        'dec_example', os.path.join(REPO, 'examples', 'dec', 'dec.py'))
    dec = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dec)
    saved = mx.init.Xavier.__dict__.get('__call__')
    mx.init.Xavier.__call__ = _numpy_init(seed)
    try:
        return {'accuracy': np.array(dec.main(quick=True))}
    finally:
        if saved is None:
            del mx.init.Xavier.__call__
        else:
            mx.init.Xavier.__call__ = saved
