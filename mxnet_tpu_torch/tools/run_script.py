"""Run a script written for the JAX package on the port, unedited.

  python -m mxnet_tpu_torch.tools.run_script [--device cpu] script.py [args]

The counterpart of `python script.py` for the JAX package: a finder put
first on `sys.meta_path` resolves `mxnet_tpu` and every `mxnet_tpu.X` to
the very module object of `mxnet_tpu_torch` and `mxnet_tpu_torch.X`,
then the script runs as `__main__` (`runpy.run_path`) with `sys.argv`
set to the script and its arguments and the script's directory first on
`sys.path`, as `python script.py` sets them. A name the port lacks
raises ModuleNotFoundError: the finder claims every `mxnet_tpu` name, so
no file under a `mxnet_tpu/` directory is ever executed.

`--device cpu` runs the script inside `with mx.cpu():`, as the port's
tests do. Without it the port's rule holds: the script runs on
`cuda:0`, and the runner raises at once when CUDA is absent.

`jax` is not hidden: a script that imports it fails where JAX is not
installed, and that failure is its result.

At exit the runner asserts that `mxnet_tpu` is the port and that no
module in `sys.modules` was loaded from a `mxnet_tpu/` directory, then
prints one line to stderr, `run_script: {...}`: the module `mxnet_tpu`
resolved to, whether `jax` was imported, the port's kernel launch
counts and, where the script used CUDA, the device's peak allocated
bytes.
"""
import argparse
import importlib
import importlib.abc
import importlib.util
import json
import os
import runpy
import sys

ALIAS, PORT = 'mxnet_tpu', 'mxnet_tpu_torch'

# module name -> counters of kernel launches read at exit
LAUNCH_COUNTERS = {
    'cuda_conv': ('CONV_BN_STATS_LAUNCHES',),
    'cuda_ops': ('FLASH_FWD_LAUNCHES', 'FLASH_BWD_DKDV_LAUNCHES',
                 'FLASH_BWD_DQ_LAUNCHES'),
    'rtc': ('RTC_LAUNCHES',),
}


def _port_name(name):
    return PORT + name[len(ALIAS):]


class PortFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Claims `mxnet_tpu` and `mxnet_tpu.*`; loading one puts the port's
    module of the same dotted name in its place in `sys.modules`."""

    def find_spec(self, name, path=None, target=None):
        if name == ALIAS or name.startswith(ALIAS + '.'):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        # the import system returns what sys.modules holds under the name
        # once exec_module is done
        sys.modules[module.__name__] = importlib.import_module(
            _port_name(module.__name__))


def install():
    """Put the finder first on sys.meta_path (once)."""
    if not any(isinstance(f, PortFinder) for f in sys.meta_path):
        sys.meta_path.insert(0, PortFinder())


def _under_jax_package(path):
    return ALIAS in os.path.realpath(path).split(os.sep)


def check():
    """Raise AssertionError unless every loaded `mxnet_tpu` name is the
    port's module and no loaded module came from a `mxnet_tpu/`
    directory."""
    bad = []
    for name, mod in list(sys.modules.items()):
        if name == ALIAS or name.startswith(ALIAS + '.'):
            if mod is not sys.modules.get(_port_name(name)):
                bad.append('%s is not %s' % (name, _port_name(name)))
        path = getattr(mod, '__file__', None)
        if path and _under_jax_package(path):
            bad.append('%s was loaded from %s' % (name, path))
    if bad:
        raise AssertionError('run_script: the JAX package was reached: '
                             + '; '.join(bad))


def report():
    """The exit line's fields."""
    alias = sys.modules.get(ALIAS)
    launches = {}
    for mod_name, counters in LAUNCH_COUNTERS.items():
        mod = sys.modules.get(PORT + '.' + mod_name)
        for counter in counters:
            launches[counter] = getattr(mod, counter, 0) if mod else 0
    torch = sys.modules.get('torch')
    peak = torch.cuda.max_memory_allocated() \
        if torch is not None and torch.cuda.is_initialized() else None
    return {'mxnet_tpu': alias.__name__ if alias is not None else None,
            'jax': 'jax' in sys.modules, 'launches': launches,
            'peak_bytes': peak}


def run(script, args, device=None):
    """Run `script` as __main__ with `args`, on the port."""
    install()
    import mxnet_tpu_torch as mx
    if device is None:
        mx.context.resolve_device(None)     # cuda:0 or raise
        ctx = None
    elif device == 'cpu':
        ctx = mx.cpu()
    else:
        raise ValueError("--device takes 'cpu' only, got %r" % device)
    sys.argv = [script] + list(args)
    sys.path[0] = os.path.dirname(os.path.abspath(script))
    try:
        if ctx is None:
            runpy.run_path(script, run_name='__main__')
        else:
            with ctx:
                runpy.run_path(script, run_name='__main__')
    except SystemExit as e:
        if e.code not in (None, 0):
            raise
    check()
    print('run_script: ' + json.dumps(report()), file=sys.stderr,
          flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m mxnet_tpu_torch.tools.run_script',
        description='Run a script written for mxnet_tpu on the port.')
    p.add_argument('--device', choices=('cpu',), default=None,
                   help='run inside `with mx.cpu():` (default: cuda:0)')
    p.add_argument('script')
    p.add_argument('args', nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    run(a.script, a.args, a.device)


if __name__ == '__main__':
    main()
