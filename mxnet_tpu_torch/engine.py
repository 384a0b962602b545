"""mx.engine: the host-side dependency-scheduling engine.

The counterpart of the JAX package's `engine.py` and of the reference's
engine API (include/mxnet/engine.h: Engine::Get()->PushAsync /
WaitForVar / WaitForAll). Ops read `const_vars` and write
`mutable_vars`: readers of a variable run together, a writer alone, and
each variable's ops in the order they were pushed.

The engine orders host work: IO stages, checkpoint writes, custom host
ops. A pushed function that launches torch ops on the card only enqueues
them; the card runs them in the order of their own CUDA streams, not in
the engine's, so a function that must see a device result synchronizes
on it itself.

`Engine()` runs on the native C++ ThreadedEngine (`csrc/native/engine.cc`,
built by `_build.native_library()`) and raises `_core.NativeError` when
that library cannot be built. `MXNET_ENGINE_TYPE=NaiveEngine` selects the
Python engine that runs each op inline (the reference's NaiveEngine);
`MXNET_CPU_WORKER_NTHREADS` sets the native engine's
workers (4 by default). Native worker threads call Python through one
ctypes trampoline; every native engine is drained and its threads joined
at `close()` and at interpreter exit, before finalization begins.
"""
import atexit
import ctypes
import itertools
import os
import threading
import weakref

from . import _core

__all__ = ['Engine', 'get', 'push', 'new_variable', 'wait_for_var',
           'wait_all', 'delete_variable']

_LIVE = weakref.WeakSet()      # native engines to close at exit


def _trampoline(fns, mu, error):
    def dispatch(payload):
        cid = int(payload) if payload else 0
        with mu:
            fn = fns.pop(cid, None)
        if fn is not None:
            try:
                fn()
            except BaseException as e:
                with mu:
                    if error[0] is None:
                        error[0] = e
    return dispatch


class _NativeEngine:
    def __init__(self, num_workers):
        self._lib = _core.lib()
        self._handle = self._lib.MXTEngineCreate(num_workers)
        self._fns = {}
        self._cb_id = 0
        self._mu = threading.Lock()
        # Python exceptions cannot cross the ctypes callback boundary
        # into C++, so the first failure is latched here and rethrown at
        # the next wait (as the C++ engine's own error latch does)
        self._error = [None]
        # ONE persistent trampoline for all pushes: the payload carries
        # an id into _fns, so no CFUNCTYPE object is ever freed while a
        # C worker thread may still be inside it. It holds the op table
        # and the latch, not the engine, so the engine is in no cycle and
        # is freed (drained, its workers joined) when its last reference
        # goes, never by a collection inside one of its own workers
        self._trampoline = ctypes.CFUNCTYPE(None, ctypes.c_void_p)(
            _trampoline(self._fns, self._mu, self._error))
        _LIVE.add(self)

    def _live(self):
        if not self._handle:
            raise RuntimeError('the engine is closed')
        return self._handle

    def new_variable(self):
        return self._lib.MXTEngineNewVar(self._live())

    def push(self, fn, const_vars=(), mutable_vars=()):
        handle = self._live()
        with self._mu:
            self._cb_id += 1
            cid = self._cb_id
            self._fns[cid] = fn
        cv = (ctypes.c_int64 * max(1, len(const_vars)))(*const_vars)
        mv = (ctypes.c_int64 * max(1, len(mutable_vars)))(*mutable_vars)
        ret = self._lib.MXTEnginePush(
            handle, self._trampoline, ctypes.c_void_p(cid), cv,
            len(const_vars), mv, len(mutable_vars))
        if ret != 0:
            with self._mu:
                self._fns.pop(cid, None)
            _core.check_call(ret)

    def wait_for_var(self, var):
        _core.check_call(self._lib.MXTEngineWaitForVar(self._live(), var))
        self._rethrow()

    def wait_all(self):
        _core.check_call(self._lib.MXTEngineWaitAll(self._live()))
        self._rethrow()

    def _rethrow(self):
        with self._mu:
            err, self._error[0] = self._error[0], None
        if err is not None:
            raise RuntimeError('engine op failed: %r' % (err,)) from err

    def delete_variable(self, var):
        _core.check_call(self._lib.MXTEngineDeleteVar(self._live(), var))

    def close(self):
        """Run every pushed op, then join the workers (idempotent). A
        ctypes call releases the interpreter lock, so the workers can
        finish the Python ops still queued."""
        handle, self._handle = getattr(self, '_handle', None), None
        if handle:
            self._lib.MXTEngineFree(handle)

    def __del__(self):
        self.close()


class _PyEngine:
    """The reference's NaiveEngine: each op runs inside push(), so ops run
    in push order and every dependency is met by the time it runs. The
    first op failure is latched and raised at the next wait, as the
    native engine does."""

    def __init__(self):
        self._ids = itertools.count(1)
        self._error = None

    def new_variable(self):
        return next(self._ids)

    def push(self, fn, const_vars=(), mutable_vars=()):
        # CheckDuplicate semantics (reference threaded_engine.h:376)
        if len(set(const_vars)) != len(const_vars) or \
                len(set(mutable_vars)) != len(mutable_vars) or \
                set(const_vars) & set(mutable_vars):
            raise ValueError(
                'duplicate var handles in const/mutable lists')
        try:
            fn()
        except BaseException as e:
            if self._error is None:
                self._error = e

    def wait_for_var(self, var):
        self.wait_all()

    def wait_all(self):
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError('engine op failed: %r' % (err,)) from err

    def delete_variable(self, var):
        pass

    def close(self):
        self.wait_all()


class Engine:
    """Engine facade (reference Engine::Get())."""

    def __init__(self, num_workers=None):
        if num_workers is None:
            num_workers = int(os.environ.get(
                'MXNET_CPU_WORKER_NTHREADS', 4))
        if os.environ.get('MXNET_ENGINE_TYPE') == 'NaiveEngine':
            self._impl = _PyEngine()
        else:
            self._impl = _NativeEngine(num_workers)

    def new_variable(self):
        return self._impl.new_variable()

    def push(self, fn, const_vars=(), mutable_vars=()):
        """Run fn when all deps clear; reads const_vars, writes
        mutable_vars (reference PushAsync, engine.h:168)."""
        self._impl.push(fn, const_vars, mutable_vars)

    def wait_for_var(self, var):
        self._impl.wait_for_var(var)

    def wait_all(self):
        self._impl.wait_all()

    def delete_variable(self, var):
        self._impl.delete_variable(var)

    def close(self):
        """Run what was pushed and join the engine's threads."""
        self._impl.close()


_engine = None
_engine_mu = threading.Lock()


def get():
    global _engine
    with _engine_mu:
        if _engine is None:
            _engine = Engine()
        return _engine


def new_variable():
    return get().new_variable()


def push(fn, const_vars=(), mutable_vars=()):
    get().push(fn, const_vars, mutable_vars)


def wait_for_var(var):
    get().wait_for_var(var)


def wait_all():
    get().wait_all()


def delete_variable(var):
    get().delete_variable(var)


@atexit.register
def _close_all():
    # join every native worker while the interpreter is whole: after
    # finalization begins, a worker entering the trampoline would take
    # the interpreter lock of a dying interpreter
    for eng in list(_LIVE):
        eng.close()
