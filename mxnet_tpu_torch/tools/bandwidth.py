"""Gradient-aggregation bandwidth benchmark, on the port (the arms and
the output lines of the JAX package's tools/bandwidth.py):

  * mesh: an all-reduce over the port's data mesh (`parallel.mesh`,
    NCCL over the cards, gloo on the CPU), one process per rank;
  * ps: the parameter server's push + pull round trip
    (`kvstore_server`), worker processes against an in-process server;
  * train-cliff: one process training with kvstore='device' against
    two launcher workers with dist_sync through the server, the same
    model and per-worker batch (`Module`).

  python -m mxnet_tpu_torch.tools.bandwidth --test ps --size-mb 64 --iters 10

The mesh and train-cliff arms run on the cards (cuda:rank) unless
`--device cpu`; the ps arm moves host arrays.
"""
import argparse
import os
import sys
import tempfile
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))


def _mesh_rank(rank, size_mb, iters):
    """One rank of the mesh arm: time `iters` all-reduces of size_mb
    MB; rank 0 prints the line."""
    import torch
    from mxnet_tpu_torch.parallel import collectives
    from mxnet_tpu_torch.parallel import mesh as pmesh
    mesh = pmesh.make_mesh()
    x = torch.ones(int(size_mb * 1e6 / 4), dtype=torch.float32,
                   device=mesh.device)

    def sync():
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    collectives.allreduce_sum(x, 'data', mesh)      # warm up
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = collectives.allreduce_sum(x, 'data', mesh)
    sync()
    dt = (time.perf_counter() - t0) / iters
    del out
    gb = size_mb / 1e3
    if rank == 0:
        print('devices=%d payload=%.1fMB time=%.2fms algbw=%.2f GB/s/dev'
              % (mesh.size, size_mb, dt * 1e3, gb / dt), flush=True)


def measure_mesh(size_mb, iters, device, num_workers):
    """The mesh arm over every card (or num_workers CPU ranks)."""
    import torch
    from mxnet_tpu_torch.parallel import mesh as pmesh
    n = num_workers if device == 'cpu' else torch.cuda.device_count()
    if n < 1:
        raise RuntimeError('the mesh arm runs on the cards and '
                           'torch.cuda.device_count() is 0; pass '
                           '--device cpu to run it on the CPU')
    with tempfile.TemporaryDirectory() as tmp:
        pmesh.spawn(_mesh_rank, n, os.path.join(tmp, 'rendezvous'),
                    args=(size_mb, iters), device=device)


def _ps_worker_proc(port, size_mb, iters, q):
    """One worker process: times its own loop after a server barrier, so
    that process start and imports stay out of the measurement."""
    from mxnet_tpu_torch import kvstore_server as ps
    grad = np.ones((int(size_mb * 1e6 / 4),), np.float32)
    c = ps.DistServerClient('127.0.0.1', port, 1)
    c.push('g', grad)   # warm both directions before timing
    c.pull('g')
    c.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        # the fused round of the training path (push_pull_multi):
        # gradients up, updated weights back, one round trip
        c.push_pull_multi([('g', grad)])
    q.put(time.perf_counter() - t0)
    c.close()


def measure_ps(size_mb, iters, num_workers):
    import multiprocessing as mp
    import queue
    from mxnet_tpu_torch import kvstore_server as ps
    srv = ps.KVStoreServer(0, num_workers, sync_mode=True)
    threading.Thread(target=srv.run, daemon=True).start()
    ctl = ps.DistServerClient('127.0.0.1', srv.port, 1)
    ctl.init('g', np.zeros((int(size_mb * 1e6 / 4),), np.float32))

    ctx = mp.get_context('spawn')
    q = ctx.Queue()
    procs = [ctx.Process(target=_ps_worker_proc,
                         args=(srv.port, size_mb, iters, q))
             for _ in range(num_workers)]
    for p in procs:
        p.start()
    # a worker that dies before q.put() surfaces at once
    dts = []
    deadline = time.time() + 600
    while len(dts) < len(procs):
        try:
            dts.append(q.get(timeout=5))
        except queue.Empty:
            dead = [p for p in procs
                    if not p.is_alive() and p.exitcode not in (0, None)]
            if dead:
                raise RuntimeError('ps worker process failed (exitcode %s)'
                                   % dead[0].exitcode)
            if time.time() > deadline:
                raise RuntimeError('ps workers timed out')
    for p in procs:
        p.join()
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError('ps worker process failed')
    dt = max(dts) / iters
    ctl.stop_servers()
    gb = 2 * size_mb / 1e3      # push + pull
    print('workers=%d payload=%.1fMB time=%.2fms bw=%.2f GB/s/worker'
          % (num_workers, size_mb, dt * 1e3, gb / dt))
    return gb / dt


def _cliff_model():
    from mxnet_tpu_torch import sym
    net = sym.FullyConnected(sym.Variable('data'), num_hidden=1024,
                             name='fc1')
    net = sym.Activation(net, act_type='relu')
    net = sym.FullyConnected(net, num_hidden=1024, name='fc2')
    net = sym.Activation(net, act_type='relu')
    net = sym.FullyConnected(net, num_hidden=10, name='fc3')
    return sym.SoftmaxOutput(net, name='softmax')


def _context(device):
    import mxnet_tpu_torch as mx
    return mx.cpu() if device == 'cpu' else mx.gpu(0)


def _cliff_train(kvstore, batch, steps, device):
    """samples/s of the same model and batch under a kvstore mode."""
    import mxnet_tpu_torch as mx
    ctx = _context(device)
    mod = mx.mod.Module(_cliff_model(), label_names=['softmax_label'],
                        context=ctx)
    mod.bind(data_shapes=[mx.io.DataDesc('data', (batch, 784))],
             label_shapes=[mx.io.DataDesc('softmax_label', (batch,))])
    np.random.seed(0)
    mod.init_params(initializer=mx.init.Xavier())
    mod.init_optimizer(kvstore=kvstore, optimizer='sgd',
                       optimizer_params={'learning_rate': 0.01})
    rs = np.random.RandomState(1)
    batchobj = mx.io.DataBatch(
        data=[mx.nd.array(rs.rand(batch, 784).astype(np.float32),
                          ctx=ctx)],
        label=[mx.nd.array((rs.rand(batch) * 10).astype(np.float32),
                           ctx=ctx)])

    def sync():
        mod.get_params()[0]['fc1_weight'].wait_to_read()

    for _ in range(3):
        mod.forward_backward(batchobj)
        mod.update()
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        mod.forward_backward(batchobj)
        mod.update()
    sync()
    return batch * steps / (time.perf_counter() - t0)


def measure_train_cliff(batch, steps, device):
    """kvstore='device' in one process against 2-process dist_sync
    through the localhost server (the port's launcher, --launcher
    local), the same model and per-worker batch."""
    import subprocess
    rate_fused = _cliff_train('device', batch, steps, device)
    print('single-process kvstore=device: %.0f samples/s' % rate_fused)
    env = dict(os.environ)
    for stale in ('DMLC_PS_ROOT_URI', 'DMLC_PS_ROOT_PORT', 'DMLC_ROLE'):
        env.pop(stale, None)
    cmd = [sys.executable, '-m', 'mxnet_tpu_torch.tools.launch', '-n', '2',
           '-s', '1', '--launcher', 'local', sys.executable, '-m',
           'mxnet_tpu_torch.tools.bandwidth', '--test',
           'train-cliff-worker', '--iters', str(steps), '--batch',
           str(batch)] + (['--device', 'cpu'] if device == 'cpu' else [])
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                         env=env, cwd=os.path.join(
                             os.path.dirname(os.path.abspath(__file__)),
                             '..', '..'))
    if res.returncode != 0:
        raise RuntimeError('dist run failed: %s\n%s'
                           % (res.stdout, res.stderr))
    rates = [float(line.split()[1]) for line in res.stdout.splitlines()
             if line.startswith('CLIFF ')]
    assert len(rates) == 2, res.stdout
    agg = sum(rates)
    print('2-process dist_sync PS:        %.0f samples/s aggregate '
          '(per-worker %s)' % (agg, ['%.0f' % r for r in rates]))
    print('fusion cliff: fused/dist = x%.1f   (per-worker x%.1f)'
          % (rate_fused / agg, rate_fused / (agg / 2)))
    return rate_fused, agg


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--test', choices=['mesh', 'ps', 'train-cliff',
                                      'train-cliff-worker'],
                   default='mesh')
    p.add_argument('--size-mb', type=float, default=64.0)
    p.add_argument('--iters', type=int, default=10)
    p.add_argument('--batch', type=int, default=256)
    p.add_argument('-n', '--num-workers', type=int, default=2)
    p.add_argument('--device', choices=['cpu', 'gpu'], default='gpu',
                   help='where the mesh and train-cliff arms run')
    args = p.parse_args(argv)
    device = 'cpu' if args.device == 'cpu' else None
    if args.test == 'mesh':
        measure_mesh(args.size_mb, args.iters, device, args.num_workers)
    elif args.test == 'ps':
        measure_ps(args.size_mb, args.iters, args.num_workers)
    elif args.test == 'train-cliff':
        measure_train_cliff(args.batch, args.iters, device)
    else:
        rate = _cliff_train('dist_sync', args.batch, args.iters, device)
        print('CLIFF %.2f' % rate, flush=True)


if __name__ == '__main__':
    main()
