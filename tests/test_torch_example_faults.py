"""The port's faults that the repository's examples exposed, each pinned
on the CPU:

- memcost.py: `Executor.memory_cost` on a CPU executor gave no temp or
  peak bytes; and the eval walk kept every node's value to its end, ran
  its activations out of place, and its max pooling copied the input
  for a padding of zero and kept argmax indices no backward reads. Now
  the eval walk drops each value after its last reader, runs an
  activation in place on the fresh output of a conv, FullyConnected or
  BatchNorm that nothing else reads, and pools without indices, against
  the JAX package's outputs; the CPU peak is that of the live storages.
- train_ssd.py under `with mx.cpu():`: the staging and prefetch threads
  did not carry the caller's context, so a user iterator that makes its
  arrays with no ctx raised for want of CUDA inside them; and an error
  of the source iterator killed PrefetchingIter's thread and left its
  consumer waiting forever.
"""
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

TOL = dict(rtol=1e-5, atol=1e-6)


def _net(pkg):
    """conv -> relu (in place), BatchNorm -> sigmoid (in place), a conv
    read twice (out of place), FullyConnected -> tanh (in place), and a
    graph output that an activation reads (out of place)."""
    s = pkg.symbol
    data = s.Variable('data')
    c1 = s.Convolution(data, num_filter=4, kernel=(3, 3), pad=(1, 1),
                       name='c1')
    a1 = s.Activation(c1, act_type='relu', name='a1')
    bn = s.BatchNorm(a1, fix_gamma=False, name='bn')
    a2 = s.Activation(bn, act_type='sigmoid', name='a2')
    c2 = s.Convolution(a2, num_filter=4, kernel=(1, 1), name='c2')
    both = s.Activation(c2, act_type='tanh', name='a3') + c2
    pool = s.Pooling(both, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                     pool_type='max', name='pool')
    fc = s.FullyConnected(s.Flatten(pool), num_hidden=5, name='fc')
    a4 = s.Activation(fc, act_type='tanh', name='a4')
    fc2 = s.FullyConnected(a4, num_hidden=3, name='fc2')
    a5 = s.Activation(fc2, act_type='relu', name='a5')
    return s.Group([a5, fc2])


def _bound_pair(layout=None):
    shapes = dict(data=(2, 3, 7, 7))
    sym = _net(mx)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(3)
    args = {n: rng.randn(*s).astype(np.float32) for n, s in
            zip(sym.list_arguments(), arg_shapes)}
    auxs = {n: np.abs(rng.randn(*s)).astype(np.float32) + 0.5
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    jex = _net(jmx).simple_bind(jmx.cpu(), grad_req='null', **shapes)
    prev = os.environ.get('MXNET_TPU_LAYOUT_OPT')
    if layout is not None:
        os.environ['MXNET_TPU_LAYOUT_OPT'] = layout
    try:
        tex = sym.simple_bind(mx.cpu(), grad_req='null', **shapes)
    finally:
        if prev is None:
            os.environ.pop('MXNET_TPU_LAYOUT_OPT', None)
        else:
            os.environ['MXNET_TPU_LAYOUT_OPT'] = prev
    for ex in (jex, tex):
        ex.copy_params_from(args, auxs)
    return jex, tex


@pytest.mark.parametrize('layout', ['0', '1'])
def test_eval_walk_in_place_and_released_matches_the_jax_package(layout):
    jex, tex = _bound_pair(layout)
    names = {tex._topo[i].name for i in tex._inplace}
    assert names == {'a1', 'a2', 'a4'}, names
    jout = [o.asnumpy() for o in jex.forward(is_train=False)]
    for _ in range(2):      # in place twice gives the same again
        tout = [o.asnumpy() for o in tex.forward(is_train=False)]
        for mine, theirs in zip(tout, jout):
            np.testing.assert_allclose(mine, theirs, **TOL)
    # the train walk takes no activation in place
    jtrain = [o.asnumpy() for o in jex.forward(is_train=True)]
    ttrain = [o.asnumpy() for o in tex.forward(is_train=True)]
    for mine, theirs in zip(ttrain, jtrain):
        np.testing.assert_allclose(mine, theirs, **TOL)


@pytest.mark.parametrize('convention', ['valid', 'full'])
def test_max_pool_without_autograd_matches_the_jax_package(convention):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 9, 8).astype(np.float32)
    attrs = dict(kernel=(3, 2), stride=(2, 3), pad=(1, 0),
                 pool_type='max', pooling_convention=convention)
    want = jmx.nd.Pooling(jmx.nd.array(x), **attrs).asnumpy()
    with mx.cpu():
        eval_out = mx.nd.Pooling(mx.nd.array(x), **attrs).asnumpy()
        xt = mx.nd.array(x)
        xt.attach_grad()
        with mx.autograd.record():
            train_out = mx.nd.Pooling(xt, **attrs)
        train_out.backward()
    np.testing.assert_array_equal(eval_out, want)
    np.testing.assert_array_equal(train_out.asnumpy(), want)


def test_memory_cost_eval_peak_is_a_value_and_the_next():
    """LeNet at batch 64 (memcost.py --quick): the eval walk's peak
    above what is bound is conv1's output while the in-place tanh and
    then the max pool's output exist, no more."""
    from mxnet_tpu_torch.models import lenet
    ex = lenet.get_symbol(num_classes=10).simple_bind(
        mx.cpu(), data=(64, 1, 28, 28), grad_req='write')
    fwd = ex.memory_cost('forward')
    conv1, pool1 = 64 * 20 * 24 * 24 * 4, 64 * 20 * 12 * 12 * 4
    assert fwd['temp_bytes'] + fwd['output_bytes'] == conv1 + pool1
    bwd = ex.memory_cost('train_backward')
    assert bwd['temp_bytes'] > 2 * fwd['temp_bytes'], (fwd, bwd)


class _UserIter(mx.io.DataIter):
    """A user iterator that makes its arrays with no ctx."""

    def __init__(self, n=3):
        super().__init__(2)
        self.n, self.i = n, 0

    @property
    def provide_data(self):
        return [mx.io.DataDesc('data', (2, 3))]

    @property
    def provide_label(self):
        return [mx.io.DataDesc('softmax_label', (2,))]

    def reset(self):
        self.i = 0

    def next(self):
        if self.i >= self.n:
            raise StopIteration
        self.i += 1
        return mx.io.DataBatch(data=[mx.nd.ones((2, 3)) * self.i],
                               label=[mx.nd.zeros((2,))])


def _drain(wrap, src):
    """The data sums of every batch of `src` behind `wrap`, read in
    `with mx.cpu():` on a thread of its own (a consumer that waits
    forever fails the test instead of hanging it)."""
    out = {}

    def read():
        try:
            with mx.cpu():
                it = mx.io.PrefetchingIter(src) \
                    if wrap == 'PrefetchingIter' \
                    else mx.io.prefetch_to_device(src, device=mx.cpu())
                out['sums'] = [float(b.data[0].asnumpy().sum()) for b in it]
                it.close()
        except Exception as e:
            out['error'] = e
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(60)
    assert not reader.is_alive(), 'the consumer still waits after 60 s'
    if 'error' in out:
        raise out['error']
    return out['sums']


@pytest.mark.parametrize('wrap', ['PrefetchingIter', 'prefetch_to_device'])
def test_prefetch_threads_take_the_callers_context(wrap):
    assert _drain(wrap, _UserIter()) == [6.0, 12.0, 18.0]


class _FailingIter(_UserIter):
    def next(self):
        if self.i == 1:
            raise ValueError('the source failed')
        return super().next()


@pytest.mark.parametrize('wrap', ['PrefetchingIter', 'prefetch_to_device'])
def test_prefetch_raises_the_sources_error(wrap):
    """The JAX package's PrefetchingIter waits forever when its source
    raises (its worker thread dies); the port raises at the consumer."""
    with pytest.raises(ValueError, match='the source failed'):
        _drain(wrap, _FailingIter())
