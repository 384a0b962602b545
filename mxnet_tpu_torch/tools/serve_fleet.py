"""Self-healing fleet CLI: supervise N localhost serving replicas behind
a routing front with health-checked restarts, optional autoscaling and
canary hot-swap, on the card.

  python -m mxnet_tpu_torch.tools.serve_fleet \\
      --model mnist=/ckpt/mnist:0:data=1x784 \\
      --deadline-ms mnist=20 --priority mnist=1 \\
      --replicas 3 --port 8000 [--autoscale] [--budget-mb 512]

The model-spec grammar is that of tools/serve_http.py
(name=prefix:epoch:input=BxD[,input2=...]). The supervisor spawns
`--replicas` replica processes, each a ModelRegistry and HTTP front on
gpu(0) (or the device of a `with mx.cpu():` block around main()), warmed
before it joins the pool; spreads `POST /v1/models/<name>:predict`
across them with retry on replica death; restarts crashed or wedged
replicas with exponential backoff under a restart budget; and serves
GET /healthz and /statsz (replica table, canary state,
fleet_supervisor_* counters) on the router port. A replica that cannot
reach the card fails its spawn, and the fleet does not start.

Canary pushes are an API (`FleetSupervisor.push(name, prefix, epoch)`).

  python -m mxnet_tpu_torch.tools.serve_fleet --replica
runs ONE replica from the MXNET_TPU_FLEET_REPLICA_CONFIG /
_REPLICA_INDEX environment contract (what the supervisor spawns; exposed
for debugging a replica by hand).

The flags are those of the JAX package's tools/serve_fleet.py.
"""
import argparse
import os
import signal
import sys
import threading

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

from mxnet_tpu_torch.tools.serve_http import (  # noqa: E402
    parse_kv, parse_model_spec)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--replica', action='store_true',
                   help='run one replica from the env contract '
                        '(internal: what the supervisor spawns)')
    p.add_argument('--model', action='append',
                   help='name=prefix:epoch:input=BxD[,...] '
                        '(repeatable)')
    p.add_argument('--deadline-ms', action='append', metavar='NAME=MS')
    p.add_argument('--priority', action='append', metavar='NAME=N')
    p.add_argument('--max-batch', type=int, default=None)
    p.add_argument('--budget-mb', type=float, default=0,
                   help='per-replica registry budget (0 = env/unbounded)')
    p.add_argument('--replicas', type=int, default=2)
    p.add_argument('--min-replicas', type=int, default=None)
    p.add_argument('--max-replicas', type=int, default=None)
    p.add_argument('--autoscale', action='store_true',
                   help='spawn/retire from the counter windows')
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--port', type=int, default=8000,
                   help='router (public) port')
    return p


def main(argv=None, stop=None, on_ready=None):
    """Run the fleet until SIGINT/SIGTERM (or until `stop`, a
    threading.Event, is set when main runs off the main thread);
    `on_ready` is called with {'address': (host, port), 'supervisor':
    sup} once every replica is healthy."""
    p = build_parser()
    args = p.parse_args(argv)

    if args.replica:
        from mxnet_tpu_torch.fleet_supervisor import _replica_main
        _replica_main()
        return

    if not args.model:
        p.error('--model is required (or --replica)')
    from mxnet_tpu_torch.fleet_supervisor import FleetSupervisor

    deadlines = parse_kv(args.deadline_ms, float)
    priorities = parse_kv(args.priority, int)
    models = []
    for spec in args.model:
        name, prefix, epoch, shapes = parse_model_spec(spec)
        m = {'name': name, 'prefix': prefix, 'epoch': epoch,
             'input_shapes': {k: list(v) for k, v in shapes.items()},
             'deadline_ms': deadlines.get(name),
             'priority': priorities.get(name, 0)}
        if args.max_batch:
            m['max_batch'] = args.max_batch
        models.append(m)
    budget = int(args.budget_mb * (1 << 20)) if args.budget_mb else None

    sup = FleetSupervisor(models, replicas=args.replicas,
                          host=args.host, router_port=args.port,
                          budget_bytes=budget,
                          autoscale=args.autoscale,
                          min_replicas=args.min_replicas,
                          max_replicas=args.max_replicas)
    try:
        sup.start()
        sup.wait_healthy()
        host, port = sup.router.address
        print('fleet of %d replica(s) serving %s on http://%s:%d on %s '
              '(autoscale=%s)' % (sup.live_replicas(),
                                  [m['name'] for m in models], host, port,
                                  sup.ctx, args.autoscale), flush=True)
        if stop is None:
            stop = threading.Event()
            for s in (signal.SIGINT, signal.SIGTERM):
                signal.signal(s, lambda *_: stop.set())
        if on_ready is not None:
            on_ready({'address': (host, port), 'supervisor': sup})
        stop.wait()
        print('shutting down fleet', flush=True)
    finally:
        sup.stop()


if __name__ == '__main__':
    main()
