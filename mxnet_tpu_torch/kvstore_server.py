"""Distributed KVStore: the parameter-server processes and the worker
client, the counterpart of mxnet_tpu/kvstore_server.py (reference
src/kvstore/kvstore_dist.h, kvstore_dist_server.h).

TCP servers hold the weights and run the optimizer; workers push
gradients and pull weights, with the reference's sync semantics (a
server sums a key's gradients until every worker contributed, applies
the updater once, then answers the pulls, kvstore_dist_server.h:154).

The wire is the JAX package's, byte for byte, so that a worker of either
package talks to a server of the other: length-prefixed frames, each
tagged with HMAC-SHA256 keyed by DMLC_PS_TOKEN (or, without a token, a
key derived from DMLC_PS_ROOT_URI:PORT), or with Poly1305 under a
per-frame key when the `cryptography` package imports
(MXNET_TPU_PS_MAC=hmac|poly overrides; both peers must agree), and a
restricted codec of command tuples of scalars, strings and arrays.
Arrays travel as their dtype's name and raw bytes; bfloat16 and the
float8 types, which numpy lacks, decode to torch CPU tensors
(`_hostarray`), so neither ml_dtypes nor `cryptography` is needed.
Pickle rides only the set_optimizer channel, which refuses to run
without DMLC_PS_TOKEN; a server binding a non-loopback interface refuses
to start without it too. Keys shard over servers as the reference's:
server id = (key * 9973) % num_servers (kvstore_dist.h:292), on ports
DMLC_PS_ROOT_PORT + server id.

The server is a host process and never touches the card: its updates
run on cpu(0) (a float32, float64 or float16 weight under plain SGD by
the numpy arithmetic the JAX server uses, bit for bit; anything else,
bfloat16 weights among them, through the port's own optimizer on torch
CPU tensors), and it initializes no CUDA context. Roles come from the
DMLC_* env contract that `mxnet_tpu_torch.tools.launch` sets;
`python -m mxnet_tpu_torch.kvstore_server` runs a server until STOP.
"""
import hashlib
import hmac
import os
import pickle
import signal
import socket
import struct
import threading
import time

import numpy as np

from . import _hostarray as ha

# ---------------------------------------------------------------------------
# framing — length + HMAC-SHA256 tag + restricted codec (see trust
# boundary note in the module docstring)
# ---------------------------------------------------------------------------

def _frame_key():
    token = os.environ.get('DMLC_PS_TOKEN')
    if token:
        return token.encode()
    seed = '%s:%s' % (os.environ.get('DMLC_PS_ROOT_URI', '127.0.0.1'),
                      os.environ.get('DMLC_PS_ROOT_PORT', '9091'))
    return hashlib.sha256(('mxnet_tpu_ps:' + seed).encode()).digest()


_MAC_TEMPLATE = (None, None)   # (key, primed hmac object)


def _mac():
    """Fresh HMAC for the current frame key.  OpenSSL 3 makes every
    `hmac.new` pay a multi-ms algorithm fetch (measured 2.9 ms — more
    than hashing a 16 MB tensor); cloning a primed template via
    HMAC.copy() is microseconds.  Keyed so an env-var token change
    (tests do this) still takes effect."""
    global _MAC_TEMPLATE
    key = _frame_key()
    tkey, tmpl = _MAC_TEMPLATE
    if tkey != key:
        tmpl = hmac.new(key, digestmod=hashlib.sha256)
        _MAC_TEMPLATE = (key, tmpl)
    return tmpl.copy()


# Frame MAC algorithms.  HMAC-SHA256 measures ~1.3 GB/s on this class
# of host — for multi-MB tensors the MAC, not the socket, bounds PS
# throughput (docs/PERF.md round 5).  When the `cryptography` package
# is present, frames authenticate with Poly1305 (~9 GB/s measured)
# under a fresh one-time key derived per frame:
#     k_frame = HMAC-SHA256(frame_key, nonce16);  tag = Poly1305(k_frame)
# (the standard one-time-MAC construction — deriving the per-message
# key through a PRF is exactly how ChaCha20-Poly1305 uses it; a
# tampered nonce derives a different key and the tag check fails).
# Override with MXNET_TPU_PS_MAC=hmac|poly; both peers must agree
# (same install + env — a mismatch fails loudly at verification).
_ALG_HMAC = 0
_ALG_POLY = 1
_POLY1305 = None


def _poly1305_cls():
    global _POLY1305
    if _POLY1305 is None:
        try:
            from cryptography.hazmat.primitives.poly1305 import Poly1305
            _POLY1305 = Poly1305
        except ImportError:
            _POLY1305 = False
    return _POLY1305


def _mac_alg():
    pref = os.environ.get('MXNET_TPU_PS_MAC', 'auto')
    if pref == 'hmac':
        return _ALG_HMAC
    if pref == 'poly':
        if not _poly1305_cls():
            raise RuntimeError('MXNET_TPU_PS_MAC=poly needs the '
                               '"cryptography" package')
        return _ALG_POLY
    return _ALG_POLY if _poly1305_cls() else _ALG_HMAC


def _frame_tag(alg, nonce, parts):
    """MAC over the payload parts under the current frame key.
    Returns a 32-byte tag (Poly1305's 16-byte tag is zero-padded)."""
    if alg == _ALG_POLY:
        kdf = _mac()
        kdf.update(nonce)
        p = _poly1305_cls()(kdf.digest())
        for v in parts:
            p.update(v)
        return p.finalize() + b'\x00' * 16
    mac = _mac()
    for v in parts:
        mac.update(v)
    return mac.digest()


_MAX_WIRE_DEPTH = 8


def _wire_dtype(name):
    """The dtype name of an array on the wire, checked: numpy's numeric
    kinds, and the dtypes numpy lacks by an explicit list (never a
    getattr on a peer-chosen name). str, void and datetime dtypes have
    surprising frombuffer semantics and the data path never needs
    them."""
    if name in ha.TORCH_ONLY:
        return name
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError('dtype %r not allowed on the PS wire' % name)
    if dt.kind not in 'biufc':
        raise ValueError('non-numeric dtype %r not allowed on the PS wire'
                         % name)
    return dt.name


def _itemsize(name):
    if name in ha.TORCH_ONLY:
        return ha.TORCH_ONLY[name].itemsize
    return np.dtype(name).itemsize


def _encode_obj(obj, out, depth=0):
    if depth > _MAX_WIRE_DEPTH:
        raise ValueError('PS wire object too deeply nested')
    if obj is None:
        out.append(b'N')
    elif obj is True:
        out.append(b'T')
    elif obj is False:
        out.append(b'F')
    elif isinstance(obj, int):
        s = str(obj).encode()
        out.append(b'i' + struct.pack('<I', len(s)) + s)
    elif isinstance(obj, float):
        out.append(b'f' + struct.pack('<d', obj))
    elif isinstance(obj, str):
        s = obj.encode()
        out.append(b's' + struct.pack('<I', len(s)) + s)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(b'b' + struct.pack('<I', len(obj)) + bytes(obj))
    elif isinstance(obj, np.generic):
        _encode_obj(obj.item(), out, depth)
    elif isinstance(obj, np.ndarray) or ha.is_torch(obj):
        if isinstance(obj, np.ndarray) and obj.dtype.hasobject:
            raise ValueError('object arrays not allowed on the PS wire')
        a = ha.host(obj)
        a = ha.contiguous(a)
        name = ha.dtype_name(a).encode()
        shape = tuple(a.shape)
        out.append(b'a' + struct.pack('<I', len(name)) + name +
                   struct.pack('<I', len(shape)) +
                   struct.pack('<%dq' % len(shape), *shape))
        # zero-copy: the array's buffer rides to sendmsg and the MAC
        # directly (the caller must not mutate it until the frame is
        # sent); a uint8 view handles 0-d arrays and the dtypes the
        # buffer protocol cannot format
        out.append(memoryview(ha.raw_bytes(a)))
    elif isinstance(obj, (tuple, list)):
        out.append(b't' + struct.pack('<I', len(obj)))
        for v in obj:
            _encode_obj(v, out, depth + 1)
    elif isinstance(obj, dict):
        out.append(b'd' + struct.pack('<I', len(obj)))
        for k, v in obj.items():
            _encode_obj(k, out, depth + 1)
            _encode_obj(v, out, depth + 1)
    else:
        raise ValueError('type %s not allowed on the PS wire'
                         % type(obj).__name__)


def _decode_obj(buf, pos, depth=0):
    if depth > _MAX_WIRE_DEPTH:
        raise ValueError('PS wire object too deeply nested')
    tag = buf[pos:pos + 1]
    pos += 1
    if tag == b'N':
        return None, pos
    if tag == b'T':
        return True, pos
    if tag == b'F':
        return False, pos
    if tag == b'f':
        return struct.unpack_from('<d', buf, pos)[0], pos + 8
    if tag in (b'i', b's', b'b'):
        (n,) = struct.unpack_from('<I', buf, pos)
        pos += 4
        raw = bytes(buf[pos:pos + n])
        if len(raw) != n:
            raise ValueError('truncated PS frame')
        pos += n
        if tag == b'i':
            return int(raw.decode()), pos
        if tag == b's':
            return raw.decode(), pos
        return raw, pos
    if tag == b'a':
        (n,) = struct.unpack_from('<I', buf, pos)
        pos += 4
        name = _wire_dtype(bytes(buf[pos:pos + n]).decode())
        pos += n
        (ndim,) = struct.unpack_from('<I', buf, pos)
        pos += 4
        if ndim > 32:
            raise ValueError('bad ndim on PS wire')
        shape = struct.unpack_from('<%dq' % ndim, buf, pos)
        pos += 8 * ndim
        if any(d < 0 for d in shape):
            raise ValueError('bad shape on PS wire')
        count = int(np.prod(shape, dtype=np.int64)) if ndim else 1
        nbytes = count * _itemsize(name)
        if len(buf) - pos < nbytes:
            raise ValueError('truncated PS frame')
        raw = memoryview(buf)[pos:pos + nbytes]
        pos += nbytes
        # a view into the recv buffer for numpy dtypes: every consumer
        # (push merge, init, the client's device upload) copies or
        # reduces at once, so nothing pins the frame long-term
        return ha.from_buffer(raw, name, shape), pos
    if tag == b't':
        (n,) = struct.unpack_from('<I', buf, pos)
        pos += 4
        items = []
        for _ in range(n):
            v, pos = _decode_obj(buf, pos, depth + 1)
            items.append(v)
        return tuple(items), pos
    if tag == b'd':
        (n,) = struct.unpack_from('<I', buf, pos)
        pos += 4
        d = {}
        for _ in range(n):
            k, pos = _decode_obj(buf, pos, depth + 1)
            v, pos = _decode_obj(buf, pos, depth + 1)
            d[k] = v
        return d, pos
    raise ValueError('unknown PS wire tag %r' % tag)


def _encode(obj):
    out = []
    _encode_obj(obj, out)
    return b''.join(out)


def _decode(payload):
    obj, pos = _decode_obj(payload, 0)
    if pos != len(payload):
        raise ValueError('trailing bytes in PS frame')
    return obj


def _build_frame(obj):
    """Encode + MAC a message into a scatter-gather parts list
    (header first).  The payload is never concatenated: the MAC runs
    incrementally over the parts and sendmsg takes the list, so a
    multi-MB tensor costs zero framing copies.
    Header layout: length u64 | alg u8 | nonce 16 | tag 32."""
    out = []
    _encode_obj(obj, out)
    total = 0
    parts = []
    for p in out:
        v = p if isinstance(p, memoryview) else memoryview(p)
        total += v.nbytes
        parts.append(v)
    alg = _mac_alg()
    nonce = os.urandom(16) if alg == _ALG_POLY else b'\x00' * 16
    tag = _frame_tag(alg, nonce, parts)
    header = struct.pack('<QB', total, alg) + nonce + tag
    return [memoryview(header)] + parts


_IOV_MAX = 1024  # kernel sendmsg iovec limit; more parts -> EMSGSIZE


def _send_parts(sock, parts):
    """Scatter-gather send with partial-send continuation, chunked to
    the kernel's iovec limit (multi-key frames can carry thousands of
    parts)."""
    parts = list(parts)
    while parts:
        batch = parts[:_IOV_MAX]
        total = sum(p.nbytes for p in batch)
        sent = sock.sendmsg(batch)
        while sent < total:
            # drop fully-sent parts, trim the partial one, resend
            rest = []
            for p in batch:
                if sent >= p.nbytes:
                    sent -= p.nbytes
                elif sent > 0:
                    rest.append(p[sent:])
                    sent = 0
                else:
                    rest.append(p)
            batch = rest
            total = sum(p.nbytes for p in batch)
            sent = sock.sendmsg(batch)
        parts = parts[_IOV_MAX:]


def _send_msg(sock, obj):
    _send_parts(sock, _build_frame(obj))


def _recv_exact(sock, n):
    # recv_into a preallocated buffer: the bytes-concat loop is
    # quadratic for multi-MB tensors.  Returns the bytearray itself —
    # decoding slices it through memoryviews, so no whole-frame copy.
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError('socket closed')
        got += r
    return buf


# Upper bound on a single wire frame.  The length prefix arrives before
# HMAC verification, so an unauthenticated peer could otherwise force
# multi-GB allocations; anything legitimate (one tensor + envelope) fits
# far below this.  Override via MXNET_TPU_PS_MAX_FRAME (bytes).
_MAX_FRAME_BYTES = int(os.environ.get('MXNET_TPU_PS_MAX_FRAME',
                                      4 * 1024 * 1024 * 1024))


def _recv_msg(sock):
    head = _recv_exact(sock, 8 + 1 + 16 + 32)
    n, alg = struct.unpack_from('<QB', head, 0)
    if n > _MAX_FRAME_BYTES:
        raise ConnectionError(
            'kvstore frame length %d exceeds limit %d (set '
            'MXNET_TPU_PS_MAX_FRAME to raise)' % (n, _MAX_FRAME_BYTES))
    if alg not in (_ALG_HMAC, _ALG_POLY):
        raise ConnectionError('unknown kvstore frame MAC alg %d' % alg)
    if alg == _ALG_POLY and not _poly1305_cls():
        raise ConnectionError(
            'peer sent a Poly1305-tagged frame but the "cryptography" '
            'package is missing here — install it or set '
            'MXNET_TPU_PS_MAC=hmac on every role')
    nonce = bytes(head[9:25])
    tag = bytes(head[25:57])
    payload = _recv_exact(sock, n)
    want = _frame_tag(alg, nonce, (payload,))
    if not hmac.compare_digest(tag, want):
        raise ConnectionError(
            'kvstore frame failed MAC verification (wrong '
            'DMLC_PS_TOKEN or untrusted peer) — dropping connection')
    try:
        # any decode failure (truncated struct, bad tag, bad dtype,
        # over-deep nesting) means a broken or hostile peer: surface
        # uniformly as ConnectionError so server threads drop the
        # connection instead of dying with a stray traceback
        msg = _decode(payload)
    except Exception as e:
        raise ConnectionError('malformed kvstore frame: %s' % e)
    if not isinstance(msg, tuple) or not msg or \
            not isinstance(msg[0], str):
        raise ConnectionError('kvstore frame is not a command tuple')
    return msg


def _tune_sock_bufs(sock, nbytes=4 * 1024 * 1024):
    """Multi-MB tensor frames drain far fewer syscalls with MB-scale
    kernel buffers than the ~200 KB defaults (best-effort; the kernel
    clamps to its rmem/wmem caps)."""
    for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
        try:
            sock.setsockopt(socket.SOL_SOCKET, opt, nbytes)
        except OSError:
            pass


def _key_to_server(key, num_servers):
    """Reference key sharding: (key * 9973) % n (kvstore_dist.h:292);
    string keys hash first."""
    k = key if isinstance(key, int) else \
        int.from_bytes(str(key).encode(), 'little') % (1 << 31)
    return (k * 9973) % num_servers


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

def _generic_updater(optimizer, store):
    """Any pickled optimizer, driven through the port's NDArray
    machinery on cpu(0) (never the card: `nd.array` would default to
    gpu(0)). Correct for every optimizer and dtype."""
    from . import optimizer as opt
    from . import ndarray as nd
    from .context import cpu
    updater = opt.get_updater(optimizer)
    ctx = cpu(0)

    def host_updater(key, grad):
        w = nd.NDArray(ha.to_tensor(ha.copy(store[key])), ctx)
        g = nd.NDArray(ha.to_tensor(grad), ctx)
        with ctx:
            updater(key, g, w)
        store[key] = ha.host(w)
    return host_updater


def _np_fast_updater(optimizer, store):
    """Pure-numpy server-side update for stock plain SGD(+momentum), the
    JAX server's own arithmetic (rescale, clip, + wd * w, momentum) on
    the dtypes numpy has, so its bits equal the JAX server's. Returns
    None for anything it cannot reproduce in numpy; a key whose weight
    numpy cannot hold (bfloat16) takes `fallback`, the generic path."""
    from . import optimizer as opt
    if type(optimizer) is not opt.SGD or optimizer.multi_precision:
        return None
    states = {}
    fallback = []

    def upd(key, grad):
        w = store[key]
        if ha.is_torch(w):
            if not fallback:
                fallback.append(_generic_updater(optimizer, store))
            return fallback[0](key, grad)
        lr = optimizer._get_lr(key)
        wd = optimizer._get_wd(key)
        optimizer._update_count(key)
        g = np.asarray(grad, dtype=w.dtype) * optimizer.rescale_grad
        if optimizer.clip_gradient is not None:
            np.clip(g, -optimizer.clip_gradient,
                    optimizer.clip_gradient, out=g)
        g += wd * w
        if optimizer.momentum == 0.0:
            store[key] = w - lr * g
        else:
            m = states.get(key)
            if m is None:
                m = np.zeros_like(w)
            m = optimizer.momentum * m - lr * g
            states[key] = m
            store[key] = w + m
    return upd


class KVStoreServer(object):
    """One parameter-server process (reference KVStoreDistServer)."""

    def __init__(self, port, num_workers, sync_mode=True):
        self.num_workers = num_workers
        self.sync_mode = sync_mode
        self.store = {}               # key -> np.ndarray (weights)
        self.merge_buf = {}           # key -> (sum, count) during a round
        self.version = {}             # key -> number of applied updates
        self.updater = None
        self.cv = threading.Condition()
        self.stopped = False
        self.barrier_count = 0        # anonymous (legacy) arrivals
        self.barrier_ranks = set()    # rank-identified arrivals
        self.barrier_gen = 0
        # failure detection (reference ps-lite heartbeats ->
        # KVStore::get_num_dead_node, kvstore.h:287): clients identify
        # their rank once ('hello'); EVERY message on that connection
        # then stamps liveness.  Never-seen workers age from server
        # start, so a worker that dies during startup is detectable.
        self.start_time = time.time()
        self.last_seen = {}           # worker rank -> time.time()
        self._frame_cache = {}        # (key,ver)-tuple -> reply frame
        self.rounds = 0               # applied key rounds
        self.update_ms = 0.0          # host ms spent in those updates
        # single-flight for reply-frame builds: with the fused
        # push_pull round every worker's handler thread wakes on the
        # same version bump and would otherwise encode+MAC the same
        # frame concurrently (pure waste on shared-core hosts)
        self._frame_build_lock = threading.Lock()
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # bind the rendezvous interface when it is local (loopback for
        # tools/launch.py local mode) rather than all interfaces; a
        # server on a different host than the root falls back to ''
        bind_addr = os.environ.get(
            'DMLC_PS_BIND_URI',
            os.environ.get('DMLC_PS_ROOT_URI', '127.0.0.1'))
        self._check_bind_policy(bind_addr)
        try:
            self.listener.bind((bind_addr, port))
        except OSError as e:
            import errno
            addr_unusable = e.errno == errno.EADDRNOTAVAIL or \
                isinstance(e, socket.gaierror)
            if not addr_unusable:
                raise  # busy port etc. would fail the fallback too —
                #        don't mask it with a token complaint
            # a server on a different host than the rendezvous root
            # cannot bind the root address (EADDRNOTAVAIL) — fall back
            # to all interfaces, which requires the shared secret
            self._check_bind_policy('')
            self.listener.bind(('', port))
        self.listener.listen(num_workers + 8)
        self.port = self.listener.getsockname()[1]
        self._threads = []

    @staticmethod
    def _check_bind_policy(bind_addr):
        """Refuse a non-loopback bind without a real shared secret: the
        fallback frame key is derived from the (public) rendezvous
        address, so off-host it authenticates nothing."""
        if os.environ.get('DMLC_PS_TOKEN'):
            return
        addr = (bind_addr or '').strip('[]')
        loopback = addr in ('localhost', '::1') or \
            addr.startswith('127.')
        if not loopback:
            raise RuntimeError(
                'kvstore server: refusing to bind %r without '
                'DMLC_PS_TOKEN — the default frame key derives from '
                'the public rendezvous address and cannot '
                'authenticate remote peers.  Set DMLC_PS_TOKEN to a '
                'shared secret (tools/launch.py exports it to every '
                'role), or bind loopback for single-host runs.'
                % (bind_addr or '<all interfaces>'))

    # -- message handlers ---------------------------------------------------
    def _handle_init(self, key, value):
        with self.cv:
            if key not in self.store:
                self.store[key] = ha.copy(value)
        return ('ok',)

    def _handle_push(self, key, value):
        merged = None
        with self.cv:
            if key not in self.store:
                # late init push (reference inits on first push too)
                self.store[key] = ha.copy(value) * 0
            if not self.sync_mode:
                # async pushes may arrive concurrently for one key, so
                # the read-modify-write update must stay under the lock
                self._apply(key, value)
                self.version[key] = self.version.get(key, 0) + 1
                self.cv.notify_all()
                return ('ok',)
            else:
                s, c = self.merge_buf.get(key, (None, 0))
                s = ha.copy(value) if s is None else s + value
                c += 1
                if c >= self.num_workers:
                    self.merge_buf.pop(key, None)
                    merged = s   # round complete: update outside the lock
                else:
                    self.merge_buf[key] = (s, c)
                    # sync push acks immediately; the worker's next pull
                    # waits for the round via the key version
        if merged is not None:
            # sync mode: optimizer math runs OUTSIDE the global lock so
            # pulls, barriers and other keys' pushes proceed
            # concurrently; exactly one thread completes a given key's
            # round, and pulls wait on the version
            self._apply(key, merged)
            with self.cv:
                self.version[key] = self.version.get(key, 0) + 1
                self.cv.notify_all()
        return ('ok',)

    def _apply(self, key, merged):
        """Apply one round's merged gradient.  Called without the global
        lock; per-key exclusivity is guaranteed by round completion (the
        caller bumps the key version under the lock afterwards)."""
        if self.updater is not None:
            t0 = time.perf_counter()
            self.updater(key, merged)     # reads + writes self.store[key]
            dt = (time.perf_counter() - t0) * 1e3
            with self.cv:
                self.rounds += 1
                self.update_ms += dt
        else:
            # `merged` may be a view into the recv frame (the async
            # push path): a copy, so that the store never pins the
            # wire buffer nor aliases it
            self.store[key] = ha.copy(merged)

    def _pull_value(self, key, min_version=0):
        """Sync semantics, deadlock-free: the pull carries the calling
        worker's own push count for this key and waits until that many
        rounds have been APPLIED (every round completes from the other
        workers' pushes, never from this worker's pull) — the versioned
        equivalent of the reference answering queued pulls after the
        update (kvstore_dist_server.h:182-218).
        -> (array_snapshot, version) or raises KeyError."""
        with self.cv:
            while self.sync_mode and \
                    self.version.get(key, 0) < min_version:
                self.cv.wait()
            if key not in self.store:
                raise KeyError(key)
            # No snapshot copy needed: _apply REPLACES self.store[key]
            # (both updater and plain paths) rather than mutating in
            # place, so the grabbed reference stays internally
            # consistent while the frame is encoded after release.
            return self.store[key], self.version.get(key, 0)

    def _pull_frame(self, keys_versions):
        """Encoded ('ok', values...) reply frame for a pull at a known
        (key, version) snapshot — cached so N workers pulling the same
        round pay ONE encode+MAC (sync rounds always converge on the
        same versions).  Only the latest snapshot per key set is kept.
        The cache is keyed by the ACTUAL snapshot versions, never the
        client's requested minimums: a client re-requesting the same
        floor after the store advanced must see the new weights."""
        with self.cv:
            # async mode: versions advance independently of the request,
            # so a version-keyed cache would serve stale weights
            cacheable = self.sync_mode
        try:
            # wait for the rounds BEFORE taking the build lock, so a
            # builder never blocks pushes that complete its own wait
            pairs = [self._pull_value(k, v) for k, v in keys_versions]
        except KeyError as e:
            return _build_frame(('err',
                                 'key %r not initialized' % (e.args[0],)))
        values = [p[0] for p in pairs]
        if not cacheable:
            reply = ('ok', values[0]) if len(values) == 1 else \
                ('ok', tuple(values))
            return _build_frame(reply)
        snap_key = tuple((k, p[1])
                         for (k, _), p in zip(keys_versions, pairs))
        with self.cv:
            hit = self._frame_cache.get(snap_key)
        if hit is not None:
            return hit
        with self._frame_build_lock:
            with self.cv:
                hit = self._frame_cache.get(snap_key)
            if hit is not None:
                return hit
            reply = ('ok', values[0]) if len(values) == 1 else \
                ('ok', tuple(values))
            frame = _build_frame(reply)
            with self.cv:
                # one live entry per key-set: stale rounds are never
                # re-requested, so the cache stays O(#distinct key groups)
                self._frame_cache = {
                    ck: fr for ck, fr in self._frame_cache.items()
                    if tuple(k for k, _ in ck) != tuple(
                        k for k, _ in snap_key)}
                self._frame_cache[snap_key] = frame
        return frame

    def _handle_barrier(self, rank=None):
        """Barrier arrival.  Rank-identified arrivals dedupe into a
        SET: a worker whose previous barrier RPC timed out client-side
        and who retries (or simply reaches its next barrier site) must
        not count twice and release the generation while a peer never
        arrived — that silent divergence is exactly what the timeout
        exists to prevent.  Anonymous (legacy client) arrivals keep
        the historical count semantics."""
        with self.cv:
            gen = self.barrier_gen
            if rank is None:
                self.barrier_count += 1
            else:
                self.barrier_ranks.add(int(rank))
            if self.barrier_count + len(self.barrier_ranks) >= \
                    self.num_workers:
                self.barrier_count = 0
                self.barrier_ranks = set()
                self.barrier_gen += 1
                self.cv.notify_all()
            else:
                while self.barrier_gen == gen:
                    self.cv.wait()
        return ('ok',)

    def _handle_set_optimizer(self, blob):
        # The ONE channel that deserializes code by design (the
        # reference ships pickled optimizers to servers the same way,
        # kvstore.py:239).  A guessable derived frame key must not be
        # able to reach it: require the real shared secret even on
        # loopback — launch.py mints one for every job.
        if not os.environ.get('DMLC_PS_TOKEN'):
            return ('err',
                    'set_optimizer requires DMLC_PS_TOKEN (it '
                    'transports executable optimizer code); set a '
                    'shared secret or run a worker-side updater '
                    'instead')
        optimizer = pickle.loads(blob)
        self.updater = _np_fast_updater(optimizer, self.store) or \
            _generic_updater(optimizer, self.store)
        return ('ok',)

    def report(self):
        """What the server did: applied key rounds, the host ms of their
        updates, the keys it holds, and whether CUDA was initialized in
        this process (it must not be)."""
        import torch
        with self.cv:
            return {'cuda_initialized': bool(torch.cuda.is_initialized()),
                    'rounds': self.rounds, 'update_ms': self.update_ms,
                    'keys': len(self.store)}

    # -- loop ---------------------------------------------------------------
    def _serve_conn(self, conn):
        conn_rank = None
        try:
            while True:
                msg = _recv_msg(conn)
                op = msg[0]
                if conn_rank is not None:
                    # any traffic from an identified worker is liveness
                    with self.cv:
                        self.last_seen[conn_rank] = time.time()
                if op == 'hello':
                    conn_rank = int(msg[1])
                    with self.cv:
                        self.last_seen[conn_rank] = time.time()
                    _send_msg(conn, ('ok',))
                    continue
                elif op == 'heartbeat':
                    with self.cv:
                        self.last_seen[int(msg[1])] = time.time()
                    _send_msg(conn, ('ok',))
                    continue
                elif op == 'num_dead':
                    timeout = float(msg[1])
                    with self.cv:
                        now = time.time()
                        dead = sum(
                            1 for r in range(self.num_workers)
                            if now - self.last_seen.get(
                                r, self.start_time) > timeout)
                    _send_msg(conn, ('ok', dead))
                    continue
                elif op == 'init':
                    reply = self._handle_init(msg[1], msg[2])
                elif op == 'push':
                    reply = self._handle_push(msg[1], msg[2])
                elif op == 'push_multi':
                    # one frame, many keys: one MAC per round instead
                    # of one per key (reference ZPush batching role)
                    reply = ('ok',)   # an empty key list is a no-op
                    for k, v in msg[1]:
                        reply = self._handle_push(k, v)
                        if reply[0] != 'ok':
                            break
                elif op == 'push_pull_multi':
                    # the whole training-step round in ONE round trip:
                    # push every key, wait for the rounds, reply with
                    # the updated weights (the ack and pull-request
                    # legs of the two-RPC form disappear)
                    err = None
                    for k, v, _ in msg[1]:
                        r = self._handle_push(k, v)
                        if r[0] != 'ok':
                            err = r
                            break
                    if err is not None:
                        reply = err
                    else:
                        frame = self._pull_frame(tuple(
                            (k, mv) for k, _, mv in msg[1]))
                        _send_parts(conn, frame)
                        continue
                elif op == 'pull':
                    frame = self._pull_frame(
                        ((msg[1], msg[2] if len(msg) > 2 else 0),))
                    _send_parts(conn, frame)
                    continue
                elif op == 'pull_multi':
                    frame = self._pull_frame(tuple(
                        (k, v) for k, v in msg[1]))
                    _send_parts(conn, frame)
                    continue
                elif op == 'barrier':
                    reply = self._handle_barrier(
                        msg[1] if len(msg) > 1 else None)
                elif op == 'set_optimizer':
                    reply = self._handle_set_optimizer(msg[1])
                elif op == 'set_sync':
                    with self.cv:
                        self.sync_mode = bool(msg[1])
                    reply = ('ok',)
                elif op == 'get_states':
                    with self.cv:
                        # Deep-copy under the lock (same torn-tensor
                        # hazard as _pull_value).
                        reply = ('ok', {k: ha.copy(v)
                                        for k, v in self.store.items()})
                elif op == 'has_updater':
                    reply = ('ok', self.updater is not None)
                elif op == 'stop':
                    with self.cv:
                        self.stopped = True
                        self.cv.notify_all()
                    _send_msg(conn, ('ok',))
                    break
                else:
                    reply = ('err', 'unknown op %r' % (op,))
                _send_msg(conn, reply)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def run(self):
        """Serve until STOP (reference KVStoreDistServer::Run :135)."""
        self.listener.settimeout(0.2)
        while True:
            with self.cv:
                if self.stopped:
                    break
            try:
                conn, _ = self.listener.accept()
                # small 'ok' replies must not wait out Nagle+delayed-ACK
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                _tune_sock_bufs(conn)
            except socket.timeout:
                continue
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)
        self.listener.close()


# ---------------------------------------------------------------------------
# worker-side client
# ---------------------------------------------------------------------------

class DistServerClient(object):
    """Worker connections to all servers (reference ps::KVWorker)."""

    def __init__(self, host, base_port, num_servers, rank=None):
        self.num_servers = num_servers
        self.push_counts = {}         # key -> this worker's push count
        self._host = host
        self._base_port = base_port
        self._rank = rank
        self.socks = []
        self.locks = []
        for i in range(num_servers):
            self.socks.append(None)
            self.locks.append(threading.Lock())
        for sid in range(num_servers):
            with self.locks[sid]:
                self._reconnect(sid)

    def _reconnect(self, sid):
        """Fresh connection to server `sid` (caller holds its lock):
        used at startup and after a timed-out RPC dropped the old,
        desynchronized socket.  Re-identifies the rank so liveness
        stamping survives the reconnect."""
        s = self._connect_retry(self._host, self._base_port + sid)
        # blocking mode: sync pulls/barriers legitimately wait for
        # peers that may still be starting up (a worker's imports are slow)
        s.settimeout(None)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _tune_sock_bufs(s)
        self.socks[sid] = s
        if self._rank is not None:
            # identify once; all subsequent RPCs on this connection
            # double as heartbeats (no extra per-op round trips)
            _send_msg(s, ('hello', int(self._rank)))
            _recv_msg(s)
        return s

    @staticmethod
    def _connect_retry(host, port, total_timeout=120.0):
        """Workers may start before their servers finish booting."""
        import time
        deadline = time.time() + total_timeout
        while True:
            try:
                return socket.create_connection((host, port), timeout=5)
            except OSError:
                if time.time() >= deadline:
                    raise
                time.sleep(0.2)

    def _rpc(self, sid, *msg, **kw):
        timeout = kw.pop('timeout', None)
        assert not kw
        with self.locks[sid]:
            sock = self.socks[sid]
            if sock is None:        # dropped after a timed-out RPC
                sock = self._reconnect(sid)
            old = sock.gettimeout()
            try:
                if timeout is not None:
                    sock.settimeout(timeout)
                _send_msg(sock, msg)
                reply = _recv_msg(sock)
            except socket.timeout:
                # the late reply stays buffered on this socket — a
                # retry would read it as ITS OWN answer.  Close and
                # forget the connection; the next RPC reconnects.
                try:
                    sock.close()
                except OSError:
                    pass
                self.socks[sid] = None
                from .base import MXNetError
                raise MXNetError(
                    'kvstore server %d did not answer %r within %.1fs'
                    % (sid, msg[0], timeout))
            finally:
                try:
                    sock.settimeout(old)
                except OSError:
                    pass
        if reply[0] != 'ok':
            from .base import MXNetError
            raise MXNetError('kvstore server error: %s' % (reply[1],))
        return reply[1] if len(reply) > 1 else None

    def _sid(self, key):
        return _key_to_server(key, self.num_servers)

    def init(self, key, value):
        self._rpc(self._sid(key), 'init', key, ha.host(value))

    def push(self, key, value):
        self.push_counts[key] = self.push_counts.get(key, 0) + 1
        self._rpc(self._sid(key), 'push', key, ha.host(value))

    def pull(self, key):
        return self._rpc(self._sid(key), 'pull', key,
                         self.push_counts.get(key, 0))

    def _multi_rpc(self, op, by_sid):
        """One frame per server, all servers in flight before any reply
        is read — per-key round trips collapse to one per server and
        the servers work concurrently."""
        sids = sorted(by_sid)
        for sid in sids:
            self.locks[sid].acquire()
        try:
            for sid in sids:
                if self.socks[sid] is None:   # dropped after timeout
                    self._reconnect(sid)
                _send_msg(self.socks[sid], (op, by_sid[sid]))
            out = {}
            for sid in sids:
                reply = _recv_msg(self.socks[sid])
                if reply[0] != 'ok':
                    from .base import MXNetError
                    raise MXNetError('kvstore server error: %s'
                                     % (reply[1],))
                out[sid] = reply[1] if len(reply) > 1 else None
            return out
        finally:
            for sid in sids:
                self.locks[sid].release()

    def push_multi(self, pairs):
        """Push [(key, value), ...] — one frame (one MAC) per server."""
        by_sid = {}
        for k, v in pairs:
            self.push_counts[k] = self.push_counts.get(k, 0) + 1
            by_sid.setdefault(self._sid(k), []).append(
                (k, ha.host(v)))
        self._multi_rpc('push_multi', by_sid)

    def pull_multi(self, keys):
        """Pull many keys -> {key: value}, one frame per server; the
        server answers from its per-round reply-frame cache."""
        by_sid = {}
        for k in keys:
            by_sid.setdefault(self._sid(k), []).append(
                (k, self.push_counts.get(k, 0)))
        replies = self._multi_rpc('pull_multi', by_sid)
        return self._scatter_pull_replies(by_sid, replies)

    def push_pull_multi(self, pairs):
        """The whole step's round in ONE round trip per server: push
        [(key, grad), ...], the servers apply completed rounds and
        reply with the updated weights -> {key: weight}."""
        by_sid = {}
        for k, v in pairs:
            self.push_counts[k] = self.push_counts.get(k, 0) + 1
            by_sid.setdefault(self._sid(k), []).append(
                (k, ha.host(v), self.push_counts[k]))
        replies = self._multi_rpc('push_pull_multi', by_sid)
        return self._scatter_pull_replies(by_sid, replies)

    @staticmethod
    def _scatter_pull_replies(by_sid, replies):
        out = {}
        for sid, items in by_sid.items():
            vals = replies[sid]
            if len(items) == 1:
                vals = (vals,)
            for item, v in zip(items, vals):
                out[item[0]] = v
        return out

    def barrier(self, timeout=None):
        """Server-side barrier.  `timeout` (seconds) bounds the wait
        per server and raises MXNetError instead of hanging on a
        wedged-but-alive peer; None keeps the historical blocking
        semantics (sync pulls legitimately wait out slow starters).
        The rank rides along so the server dedupes re-arrivals after
        a client-side timeout."""
        for sid in range(self.num_servers):
            if self._rank is not None:
                self._rpc(sid, 'barrier', int(self._rank),
                          timeout=timeout)
            else:
                self._rpc(sid, 'barrier', timeout=timeout)

    def set_optimizer(self, optimizer_blob):
        for sid in range(self.num_servers):
            self._rpc(sid, 'set_optimizer', optimizer_blob)

    def set_sync_mode(self, sync):
        for sid in range(self.num_servers):
            self._rpc(sid, 'set_sync', sync)

    def has_updater(self):
        return all(self._rpc(sid, 'has_updater')
                   for sid in range(self.num_servers))

    def heartbeat(self, rank):
        for sid in range(self.num_servers):
            self._rpc(sid, 'heartbeat', rank)

    def num_dead(self, timeout_sec):
        return max(self._rpc(sid, 'num_dead', timeout_sec)
                   for sid in range(self.num_servers))

    def stop_servers(self):
        for sid in range(self.num_servers):
            self._rpc(sid, 'stop')

    def close(self):
        for s in self.socks:
            if s is None:
                continue
            try:
                s.close()
            except OSError:
                pass


def main():
    """Server-process entry: `python -m mxnet_tpu_torch.kvstore_server`
    (the reference's `import mxnet` runs kvstore_server when
    DMLC_ROLE=server). The server is a host component: its updates run
    on cpu(0) and it never initializes CUDA (`main` reports a breach
    on stderr when it stops, and MXNET_TPU_PS_REPORT names a file that
    receives {'cuda_initialized': ..., 'rounds': ..., 'update_ms': ...}
    as JSON)."""
    role = os.environ.get('DMLC_ROLE', 'server')
    assert role in ('server', 'scheduler'), role
    num_workers = int(os.environ['DMLC_NUM_WORKER'])
    base_port = int(os.environ['DMLC_PS_ROOT_PORT'])
    server_id = int(os.environ.get('DMLC_SERVER_ID', '0'))
    sync = os.environ.get('MXNET_KVSTORE_SYNC', '1') == '1'
    server = KVStoreServer(base_port + server_id, num_workers,
                           sync_mode=sync)

    def _stop(signum, frame):
        # the launcher SIGTERMs its servers as soon as the workers have
        # exited, which can be before the run loop has seen a worker's
        # STOP: end the run as STOP does, so the report is still written
        server.stopped = True

    signal.signal(signal.SIGTERM, _stop)
    server.run()
    report = server.report()
    if report['cuda_initialized']:
        import sys
        sys.stderr.write('kvstore server: CUDA was initialized in the '
                         'server process\n')
    path = os.environ.get('MXNET_TPU_PS_REPORT')
    if path:
        import json
        with open(path, 'w') as f:
            json.dump(report, f)


if __name__ == '__main__':
    main()
