"""A rank that trains gluon.nn.MoE through the fused step over a data
mesh of two gloo ranks, then exits through the interpreter: after
`mesh.destroy_process_group()` (`destroy`), or leaving it to the
teardown init_process_group registers at exit (`atexit`). No JAX here.

    python tests/_torch_exit_rank.py RANK WORLD INIT_FILE destroy|atexit
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(rank, world, init_file, mode):
    import _torch_parallel_ranks as ranks
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import mesh
    os.environ['LOCAL_RANK'] = str(rank)
    torch.set_num_threads(1)
    mesh.init_process_group(device='cpu', init_method='file://' + init_file,
                            rank=rank, world_size=world)
    with mx.cpu():
        ranks.moe_train(mx, [mx.cpu(i) for i in range(world)], k=2)
    if mode == 'destroy':
        mesh.destroy_process_group()
    print('EXIT_RANK_OK %d' % rank, flush=True)


if __name__ == '__main__':
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
