"""Profiler: spans of the framework's dispatch units written as a Chrome
trace, the counterpart of the core of mxnet_tpu/profiler.py (reference
src/engine/profiler.{h,cc}, python/mxnet/profiler.py).

The recorded spans are the executor's forward, backward and
forward_backward (the device synchronised inside the span, so that a
duration is the work's and not its enqueue's), the imperative ops under
mode='all', and any user `profiler.scope`. `profiler_set_config(
profile_xla=True)` also runs `torch.profiler` while the profiler runs,
and `dump_profile` merges its lanes (CUDA kernels, or the host's torch
ops on a CPU-only run) at pids 100 and up, where the JAX package merges
its XLA trace's device lanes.

MXNET_PROFILER_AUTOSTART=1 starts it at import, as in the reference.
The JAX package's per-subsystem counters (exec_cache, comm, serving,
...) come with the subsystems they count.
"""
import json
import os
import threading
import time

_STATE = {
    'mode': 'symbolic',        # 'symbolic' | 'all'
    'filename': 'profile.json',
    'running': False,
    'records': [],             # (name, category, ts_us, dur_us, tid)
    'lock': threading.Lock(),
    'device_trace': False,
    'device_trace_dir': None,
    'torch_profile': None,     # the running torch.profiler.profile
    'device_events': [],       # its lanes, once stopped
}


def profiler_set_config(mode='symbolic', filename='profile.json',
                        profile_xla=False, xla_trace_dir=None):
    """Configure the profiler (reference profiler_set_config). mode:
    'symbolic' records executor-level spans; 'all' also records
    imperative ops. profile_xla adds torch.profiler's device lanes; its
    trace goes to xla_trace_dir (default: beside filename)."""
    if mode not in ('symbolic', 'all', 'all_ops'):
        raise ValueError("profiler mode must be 'symbolic', 'all' or "
                         "'all_ops', got %r" % (mode,))
    _STATE['mode'] = 'all' if mode in ('all', 'all_ops') else 'symbolic'
    _STATE['filename'] = filename
    _STATE['device_trace'] = bool(profile_xla)
    _STATE['device_trace_dir'] = xla_trace_dir or \
        os.path.splitext(filename)[0] + '_xla'


def profiler_set_state(state='stop'):
    """'run' starts recording, 'stop' halts it (reference
    MXSetProfilerState)."""
    if state not in ('run', 'stop'):
        raise ValueError("profiler state must be 'run' or 'stop', got %r"
                         % (state,))
    running = state == 'run'
    if running and not _STATE['running'] and _STATE['device_trace']:
        _start_device_trace()
    if not running and _STATE['running'] and \
            _STATE['torch_profile'] is not None:
        _stop_device_trace()
    _STATE['running'] = running


def _start_device_trace():
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    _STATE['torch_profile'] = prof


def _stop_device_trace():
    """Stop torch.profiler, write its Chrome trace under the trace
    directory and keep its lanes for dump_profile."""
    prof = _STATE['torch_profile']
    _STATE['torch_profile'] = None
    prof.__exit__(None, None, None)
    os.makedirs(_STATE['device_trace_dir'], exist_ok=True)
    path = os.path.join(_STATE['device_trace_dir'], 'torch_trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        _STATE['device_events'] = _device_lanes(json.load(f))


def _device_lanes(trace):
    """torch.profiler's trace remapped to pids 100 and up: the CUDA
    kernels' lanes where the run had any, else the host's torch ops (a
    CPU-only run), as the JAX package keeps the device lanes of its XLA
    trace, or its '/host:CPU' lane on the CPU backend."""
    raw = trace.get('traceEvents', [])
    spans = [e for e in raw if e.get('ph') == 'X']
    kernels = [e for e in spans if e.get('cat') == 'kernel']
    keep = kernels or [e for e in spans if e.get('cat') == 'cpu_op']
    names = {}
    for e in raw:
        if e.get('ph') == 'M' and e.get('name') == 'process_name':
            names[e['pid']] = e.get('args', {}).get('name', str(e['pid']))
    pids = sorted({e['pid'] for e in keep}, key=str)
    pid_map = {pid: 100 + i for i, pid in enumerate(pids)}
    out = [{'ph': 'M', 'name': 'process_name', 'pid': new,
            'args': {'name': 'torch %s' % names.get(old, old)}}
           for old, new in pid_map.items()]
    for e in keep:
        out.append({'name': e.get('name', ''), 'cat': 'xla', 'ph': 'X',
                    'ts': e.get('ts', 0), 'dur': e.get('dur', 0),
                    'pid': pid_map[e['pid']], 'tid': e.get('tid', 0)})
    return out


def dump_profile():
    """Write the recorded spans as a Chrome trace-event file (reference
    Profiler::DumpProfile), with torch.profiler's lanes at pids 100 and
    up when profile_xla was set. Returns the file name."""
    events = [{'ph': 'M', 'name': 'process_name', 'pid': 0,
               'args': {'name': 'mxnet_tpu_torch host spans'}}]
    with _STATE['lock']:
        records = list(_STATE['records'])
    for name, cat, ts, dur, tid in records:
        events.append({'name': name, 'cat': cat, 'ph': 'X',
                       'ts': ts, 'dur': dur, 'pid': 0, 'tid': tid})
    if _STATE['device_trace']:
        events.extend(_STATE['device_events'])
    with open(_STATE['filename'], 'w') as f:
        json.dump({'traceEvents': events, 'displayTimeUnit': 'ms'}, f)
    return _STATE['filename']


def is_running():
    return _STATE['running']


def mode():
    return _STATE['mode']


def record(name, category, ts_us, dur_us):
    """Append one span (the hook of the executor and imperative ops)."""
    if not _STATE['running']:
        return
    with _STATE['lock']:
        _STATE['records'].append(
            (name, category, ts_us, dur_us, threading.get_ident() % 1000))


def clear():
    with _STATE['lock']:
        _STATE['records'].clear()
        _STATE['device_events'] = []


class scope(object):
    """Context manager recording one span:
    `with profiler.scope('forward'): ...`"""

    def __init__(self, name, category='operator'):
        self.name = name
        self.category = category

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _STATE['running']:
            t1 = time.perf_counter()
            record(self.name, self.category,
                   int(self._t0 * 1e6), int((t1 - self._t0) * 1e6))
        return False


def synchronize(tensors):
    """While the profiler runs, wait for the devices of `tensors` inside
    the span: CUDA work is asynchronous, and a span would otherwise
    time the enqueue."""
    if not _STATE['running']:
        return
    import torch
    for dev in {t.device for t in tensors if t is not None and t.is_cuda}:
        torch.cuda.synchronize(dev)


if os.environ.get('MXNET_PROFILER_AUTOSTART', '0') == '1':
    profiler_set_state('run')
