"""Fleet serving HTTP front: host many checkpointed models behind
`/v1/models/<name>:predict` with SLO-aware batching, byte-budgeted
registry paging and bounded-admission backpressure (stdlib http.server
threads), on the card.

  python -m mxnet_tpu_torch.tools.serve_http \\
      --model mnist=/ckpt/mnist:0:data=1x784 \\
      --model rank=/ckpt/rank:3:data=1x256 \\
      --deadline-ms mnist=20 --priority mnist=1 \\
      --budget-mb 512 --port 8000

Model spec: name=prefix:epoch:input=BxDx...[,input2=...], the
Module.save_checkpoint artifacts (prefix-symbol.json and
prefix-NNNN.params). Each model loads on its first request (or at start
with --warm) onto gpu(0), or the device of a `with mx.cpu():` block
around main(), and is paged out under the byte budget (LRU, lowest SLO
priority first); a re-warm reloads the parameters and builds no program.

Endpoints: POST /v1/models/<name>:predict ({"inputs": {...}} or
{"instances": [...]}), GET /healthz, GET /statsz. Overload and the
in-flight admission bound answer 429 + Retry-After.

The flags are those of the JAX package's tools/serve_http.py; knob
defaults come from the MXNET_TPU_SERVE_* environment variables.
"""
import argparse
import os
import signal
import sys
import threading

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))


def parse_model_spec(spec):
    """'name=prefix:epoch:in=1x784[,in2=...]' ->
    (name, prefix, epoch, {input: shape tuple})."""
    try:
        name, rest = spec.split('=', 1)
        prefix, epoch, shapes_s = rest.rsplit(':', 2)
        shapes = {}
        for part in shapes_s.split(','):
            iname, dims = part.split('=', 1)
            shapes[iname] = tuple(int(d) for d in dims.split('x'))
        return name, prefix, int(epoch), shapes
    except ValueError:
        raise SystemExit('bad --model spec %r (want '
                         'name=prefix:epoch:input=BxD[,input2=...])'
                         % spec)


def parse_kv(pairs, cast):
    out = {}
    for p in pairs or ():
        k, v = p.split('=', 1)
        out[k] = cast(v)
    return out


def build_parser():
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0])
    p.add_argument('--model', action='append', required=True,
                   help='name=prefix:epoch:input=BxD[,...] '
                        '(repeatable)')
    p.add_argument('--deadline-ms', action='append', metavar='NAME=MS',
                   help='per-model SLO deadline (repeatable)')
    p.add_argument('--priority', action='append', metavar='NAME=N',
                   help='per-model SLO priority (repeatable)')
    p.add_argument('--budget-mb', type=float, default=0,
                   help='registry resident-weight budget '
                        '(0 = MXNET_TPU_SERVE_REGISTRY_BYTES or '
                        'unbounded)')
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--port', type=int, default=None,
                   help='default MXNET_TPU_SERVE_HTTP_PORT or 8000')
    p.add_argument('--max-inflight', type=int, default=None,
                   help='bounded admission (default '
                        'MXNET_TPU_SERVE_HTTP_INFLIGHT or 64)')
    p.add_argument('--max-batch', type=int, default=None,
                   help='per-engine coalescing bound (default '
                        'MXNET_TPU_SERVE_MAX_BATCH or 8)')
    p.add_argument('--warm', action='store_true',
                   help='load and warm every model at startup instead '
                        'of on its first request')
    return p


def main(argv=None, stop=None, on_ready=None):
    """Serve until SIGINT/SIGTERM (or until `stop`, a threading.Event, is
    set when main runs off the main thread); `on_ready` is called with
    {'address': (host, port)} once the front listens."""
    args = build_parser().parse_args(argv)

    from mxnet_tpu_torch.serving_fleet import HttpFront, ModelRegistry, SLO

    deadlines = parse_kv(args.deadline_ms, float)
    priorities = parse_kv(args.priority, int)
    budget = int(args.budget_mb * (1 << 20)) if args.budget_mb else None
    reg = ModelRegistry(budget_bytes=budget)
    names = []
    for spec in args.model:
        name, prefix, epoch, shapes = parse_model_spec(spec)
        kwargs = {}
        if args.max_batch:
            kwargs['max_batch'] = args.max_batch
        reg.register(name, prefix=prefix, epoch=epoch,
                     input_shapes=shapes,
                     slo=SLO(deadline_ms=deadlines.get(name),
                             priority=priorities.get(name, 0)),
                     **kwargs)
        names.append(name)
    if args.warm:
        for name in names:
            reg.engine(name)
            print('warmed %s' % name, flush=True)

    front = HttpFront(reg, host=args.host, port=args.port,
                      max_inflight=args.max_inflight).start()
    host, port = front.address
    print('serving %s on http://%s:%d (budget=%s bytes)'
          % (names, host, port,
             reg.budget_bytes or 'unbounded'), flush=True)
    if stop is None:
        stop = threading.Event()
        for s in (signal.SIGINT, signal.SIGTERM):
            signal.signal(s, lambda *_: stop.set())
    if on_ready is not None:
        on_ready({'address': (host, port)})
    try:
        stop.wait()
    finally:
        print('shutting down', flush=True)
        front.close()
        reg.close()


if __name__ == '__main__':
    main()
