"""A rank of a hybrid worker on the port: the JAX package's
`__graft_entry__._dist_hybrid_worker` (the dryrun's phase (f)) written
for mxnet_tpu_torch, run by its launcher with --ranks-per-worker 2.

    python -m mxnet_tpu_torch.tools.launch -n 2 -s 1 --ranks-per-worker 2 \
        python tests/_torch_hybrid_worker.py OUT_DIR ps

`ps` syncs the workers through the parameter server, `host` (with -s 0)
through the dist runtime's host all-reduce. The probe key checks the
sync-SGD arithmetic; then a Module over the worker's two contexts (a
data mesh of the worker's two ranks) takes three steps of the same
batches as the JAX worker, from OUT_DIR/init.npz. Each rank writes
OUT_DIR/w<worker>_r<rank>.npz and exits through the interpreter. No
JAX here.
"""
import os
import sys

import numpy as np

NDEV = 2


def main(out_dir, arm):
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist
    from mxnet_tpu_torch.parallel import worker_group
    if arm == 'host':
        dist.initialize()
    kv = mx.kvstore.create('dist_sync')
    group = worker_group.current()
    rank, W = kv.rank, kv.num_workers
    res = {'worker': rank, 'num_workers': W, 'group_rank': group.rank,
           'group_size': group.size,
           'world': torch.distributed.get_world_size()}
    with mx.cpu():
        kv.init('probe', mx.nd.zeros((2, 2)))
        kv.set_optimizer(mx.optimizer.create('test', rescale_grad=1.0))
        probes = []
        for _ in range(3):
            kv.push('probe', mx.nd.array(
                np.full((2, 2), float(rank + 1), np.float32)))
            out = mx.nd.zeros((2, 2))
            kv.pull('probe', out=out)
            probes.append(out.asnumpy().copy())
            kv.barrier()
        res['probe'] = np.stack(probes)
        S = mx.sym
        net = S.SoftmaxOutput(
            S.FullyConnected(S.Variable('data'), num_hidden=4, name='fc'),
            name='softmax')
        mod = mx.mod.Module(net, context=[mx.cpu(i) for i in range(NDEV)])
        bsz = 2 * NDEV
        mod.bind(data_shapes=[mx.io.DataDesc('data', (bsz, 6))],
                 label_shapes=[mx.io.DataDesc('softmax_label', (bsz,))])
        init = dict(np.load(os.path.join(out_dir, 'init.npz')))
        mod.init_params(initializer=None, arg_params={
            k: mx.nd.array(v) for k, v in init.items()})
        mod.init_optimizer(kvstore=kv, optimizer='sgd',
                           optimizer_params={'learning_rate': 0.05})
        res['rescale_grad'] = mod._optimizer.rescale_grad
        feed = np.random.RandomState(123)
        pushes = getattr(kv, 'pushes', 0)
        for _ in range(3):
            batch = mx.io.DataBatch(
                data=[mx.nd.array(feed.rand(bsz, 6).astype(np.float32))],
                label=[mx.nd.array((feed.rand(bsz) * 4).astype(np.float32))])
            mod.forward_backward(batch)
            mod.update()
        res['step_pushes'] = getattr(kv, 'pushes', 0) - pushes
        params, _ = mod.get_params()
        res['flat'] = np.concatenate([params[k].asnumpy().ravel()
                                      for k in sorted(params)])
    np.savez(os.path.join(out_dir, 'w%d_r%d.npz' % (rank, group.rank)),
             **res)
    kv.barrier()
    if arm == 'ps' and rank == 0:
        kv.stop_servers()
    if arm == 'host':
        dist.shutdown()
    print('HYBRID_OK worker=%d rank=%d' % (rank, group.rank))


if __name__ == '__main__':
    main(sys.argv[1], sys.argv[2])
