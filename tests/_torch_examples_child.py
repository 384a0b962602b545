"""Child side of tests/test_torch_examples.py and test_torch_tools.py:
runs example scripts written for the JAX package on the port, in an
interpreter of its own, through the finder of
mxnet_tpu_torch.tools.run_script (`mxnet_tpu` is the port there).

  python tests/_torch_examples_child.py quick OUT.json REL [REL ...]

loads each example (a path under the repository) as a module inside
`with mx.cpu():` and calls its `main(quick=True)`, as
tests/test_examples.py does for the JAX package, and writes
{rel: {"result": ...} or {"error": traceback}} to OUT.json, with the
runner's exit line's fields under "__report__".

  python tests/_torch_examples_child.py module OUT.npz MODULE_PATH SEED

imports the module at MODULE_PATH (a user program written for the JAX
package) and writes the arrays its `run(seed)` returns to OUT.npz.

This module imports no JAX.
"""
import importlib.util
import json
import os
import sys
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mxnet_tpu_torch.tools import run_script  # noqa: E402

run_script.install()

import mxnet_tpu_torch as mx                  # noqa: E402


def _plain(x):
    """A JSON value of an example's result."""
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (np.generic, np.ndarray)):
        return _plain(x.tolist())
    return x


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def quick(out, rels):
    results = {}
    for rel in rels:
        name = 'ex_' + os.path.splitext(os.path.basename(rel))[0]
        try:
            with mx.cpu():
                mod = _load(os.path.join(REPO, rel), name)
                results[rel] = {'result': _plain(mod.main(quick=True))}
        except Exception:
            results[rel] = {'error': traceback.format_exc()}
    run_script.check()
    results['__report__'] = run_script.report()
    with open(out, 'w') as f:
        json.dump(results, f)


def module(out, path, seed):
    with mx.cpu():
        arrays = _load(path, 'user_program').run(int(seed))
    run_script.check()
    np.savez(out, **arrays)


if __name__ == '__main__':
    cmd, out, rest = sys.argv[1], sys.argv[2], sys.argv[3:]
    if cmd == 'quick':
        quick(out, rest)
    elif cmd == 'module':
        module(out, *rest)
    else:
        raise SystemExit('unknown command %r' % cmd)
