"""The port's deployment artifact (Predictor.export_compiled and
export_artifact on torch.export) on the CPU, held against the JAX
package's.

- export_artifact's manifest lines equal the JAX package's for the same
  checkpoint (a float32 MLP and a cut bf16 ResNet);
- the .pt2, loaded by torch.export.load in a subprocess that imports
  torch alone (python -I), answers as the port's Predictor.forward, bit
  for bit, and as the JAX package's within rtol 1e-5 / atol 1e-6
  (float32 MLP);
- export_compiled returns the program and its graph text; with
  batch_buckets one dict for each rung, over the predictor's weights;
  a repeat is all exec_cache hits;
- ModelRegistry.export_artifacts returns the rungs' programs;
- a walk that cannot be traced raises naming the op.
"""
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx
from mxnet_tpu.predictor import Predictor as JPredictor

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import exec_cache, model as model_mod
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry
from mxnet_tpu_torch.predictor import Predictor
from mxnet_tpu_torch.serving_fleet import ModelRegistry

CPU = mx.cpu()
DIM, HID, OUT = 6, 8, 3
JAX_TOL = dict(rtol=1e-5, atol=1e-6)
CUT_RESNET = dict(num_classes=10, num_layers=50, image_shape='3,32,32',
                  dtype='bfloat16')

RUNNER = r'''
import sys
import torch
prog = torch.export.load(sys.argv[1]).module()
x = torch.load(sys.argv[2])
with torch.no_grad():
    out = prog(x)
assert not any(m.startswith('mxnet_tpu') for m in sys.modules), \
    sorted(m for m in sys.modules if m.startswith('mxnet_tpu'))
torch.save([o for o in out], sys.argv[3])
'''


def _mlp(pkg=mx):
    data = pkg.sym.Variable('data')
    fc1 = pkg.sym.FullyConnected(data, num_hidden=HID, name='fc1')
    act = pkg.sym.Activation(fc1, act_type='relu')
    return pkg.sym.SoftmaxOutput(
        pkg.sym.FullyConnected(act, num_hidden=OUT, name='fc2'),
        name='softmax')


def _mlp_checkpoint(tmp_path):
    rs = np.random.RandomState(0)
    args = {'fc1_weight': rs.randn(HID, DIM), 'fc1_bias': rs.randn(HID),
            'fc2_weight': rs.randn(OUT, HID), 'fc2_bias': rs.randn(OUT)}
    prefix = str(tmp_path / 'mlp')
    model_mod.save_checkpoint(
        prefix, 0, _mlp(),
        {k: mx.nd.array(v.astype(np.float32) * 0.5, ctx=CPU)
         for k, v in args.items()}, {})
    return prefix


def _resnet_checkpoint(tmp_path):
    """The cut bf16 ResNet with seeded weights and moving statistics
    near 1 (its eval forward then stays finite)."""
    symbol = mx.models.resnet.get_symbol(**CUT_RESNET)
    ex = symbol.simple_bind(CPU, grad_req='null', data=(1, 3, 32, 32))
    rs = np.random.RandomState(1)
    args = {n: mx.nd.array(rs.randn(*a.shape).astype(np.float32) * 0.05,
                           ctx=CPU)
            for n, a in ex.arg_dict.items()
            if n not in ('data', 'softmax_label')}
    auxs = {n: mx.nd.array(1.0 + 0.1 * rs.rand(*a.shape).astype(
        np.float32), ctx=CPU) for n, a in ex.aux_dict.items()}
    prefix = str(tmp_path / 'resnet')
    model_mod.save_checkpoint(prefix, 0, symbol, args, auxs)
    return prefix


def _run_alone(tmp_path, pt2, x):
    """The artifact run in a process that imports torch alone."""
    inp, out = str(tmp_path / 'in.pt'), str(tmp_path / 'out.pt')
    torch.save(torch.from_numpy(x), inp)
    proc = subprocess.run([sys.executable, '-I', '-c', RUNNER, pt2, inp,
                           out], capture_output=True, text=True,
                          timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [t.float().numpy() for t in torch.load(out)]


@pytest.mark.parametrize('kind', ['mlp', 'resnet'])
def test_manifest_equals_the_jax_packages(kind, tmp_path):
    if kind == 'mlp':
        prefix, shapes = _mlp_checkpoint(tmp_path), {'data': (2, DIM)}
    else:
        prefix, shapes = _resnet_checkpoint(tmp_path), \
            {'data': (2, 3, 32, 32)}
    ours = Predictor.from_checkpoint(prefix, 0, shapes, ctx=CPU)
    theirs = JPredictor.from_checkpoint(prefix, 0, shapes)
    lines = ours.export_artifact(str(tmp_path / 'torch_art'))
    jlines = theirs.export_artifact(str(tmp_path / 'jax_art'))
    assert lines == jlines
    with open(str(tmp_path / 'torch_art.manifest')) as f, \
            open(str(tmp_path / 'jax_art.manifest')) as g:
        assert f.read() == g.read()


def test_pt2_alone_answers_as_both_predictors(tmp_path):
    prefix = _mlp_checkpoint(tmp_path)
    ours = Predictor.from_checkpoint(prefix, 0, {'data': (2, DIM)},
                                     ctx=CPU)
    theirs = JPredictor.from_checkpoint(prefix, 0, {'data': (2, DIM)})
    ours.export_artifact(str(tmp_path / 'art'))
    x = np.random.RandomState(3).randn(2, DIM).astype(np.float32)
    got = _run_alone(tmp_path, str(tmp_path / 'art.pt2'), x)
    want = ours.forward(data=x)[0].asnumpy()
    np.testing.assert_array_equal(got[0], want)
    jwant = theirs.forward(data=jmx.nd.array(x))[0].asnumpy()
    np.testing.assert_allclose(got[0], jwant, **JAX_TOL)


def test_bf16_resnet_pt2_alone_is_bit_equal(tmp_path):
    prefix = _resnet_checkpoint(tmp_path)
    pred = Predictor.from_checkpoint(prefix, 0, {'data': (2, 3, 32, 32)},
                                     ctx=CPU)
    manifest = pred.export_artifact(str(tmp_path / 'rn'))
    assert manifest == ['input data float32 2,3,32,32',
                        'output 0 float32 2,10']
    x = np.random.RandomState(4).randn(2, 3, 32, 32).astype(np.float32)
    got = _run_alone(tmp_path, str(tmp_path / 'rn.pt2'), x)
    want = pred.forward(data=x)[0].asnumpy()
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(got[0], want)


def test_export_compiled_rungs_and_cache_hits(tmp_path):
    prefix = _mlp_checkpoint(tmp_path)
    pred = Predictor.from_checkpoint(prefix, 0, {'data': (2, DIM)},
                                     ctx=CPU)
    exec_cache.clear()
    one = pred.export_compiled()
    assert set(one) == {'program', 'graph'}
    assert isinstance(one['program'], torch.export.ExportedProgram)
    assert 'torch.ops.aten.softmax' in one['graph']
    # the program takes every argument then every aux state
    ex = pred._executor
    vals = [ex.arg_dict[n]._data for n in ex._arg_names]
    out = one['program'].module()(*vals)
    np.testing.assert_array_equal(out[0].numpy(),
                                  pred.forward()[0].asnumpy())
    before = exec_cache.stats()
    rungs = pred.export_compiled(batch_buckets=(4, 1, 2, 2))
    assert sorted(rungs) == [1, 2, 4]
    for b, art in rungs.items():
        ph = [n for n in art['program'].graph.nodes
              if n.op == 'placeholder']
        assert tuple(ph[0].meta['val'].shape) == (b, DIM)
    mid = exec_cache.stats()
    # the batch-2 rung's signature is the predictor's own: already cached
    assert mid['misses'] - before['misses'] == 2
    assert mid['hits'] - before['hits'] == 1
    assert rungs[2]['program'] is one['program']
    again = pred.export_compiled(batch_buckets=(1, 2, 4))
    after = exec_cache.stats()
    assert after['misses'] == mid['misses']
    assert after['hits'] - mid['hits'] == 3
    assert all(again[b]['program'] is rungs[b]['program'] for b in again)
    assert pred.export_compiled()['program'] is one['program']


def test_registry_export_artifacts(tmp_path):
    prefix = _mlp_checkpoint(tmp_path)
    with ModelRegistry(ctx=CPU) as reg:
        reg.register('m', prefix=prefix, epoch=0,
                     input_shapes={'data': (1, DIM)}, max_batch=2,
                     max_wait_us=0)
        arts = reg.export_artifacts('m', batch_buckets=(1, 2))
        assert sorted(arts) == [1, 2]
        assert all(isinstance(a['program'], torch.export.ExportedProgram)
                   for a in arts.values())
        assert reg.stats()['models']['m']['resident']
        one = reg.export_artifacts('m')
        assert set(one) == {'program', 'graph'}


def test_untraceable_walk_raises_naming_the_op(tmp_path, monkeypatch):
    prefix = _mlp_checkpoint(tmp_path)
    pred = Predictor.from_checkpoint(prefix, 0, {'data': (2, DIM)},
                                     ctx=CPU)
    op = registry.get('Activation')
    real = op.fcompute

    def host_read(attrs, inputs, auxs, op_ctx):
        inputs[0].cpu().numpy()         # a host read inside the walk
        return real(attrs, inputs, auxs, op_ctx)

    monkeypatch.setattr(op, 'fcompute', host_read)
    with pytest.raises(MXNetError, match='cannot be traced at op .*'
                                         r'\(Activation\)'):
        pred.export_artifact(str(tmp_path / 'bad'))
    assert not (tmp_path / 'bad.pt2').exists()
    exec_cache.clear()
    with pytest.raises(MXNetError, match='Activation'):
        pred.export_compiled()


# ---------------------------------------------------------------------------
# chip_smoke.py's gate of phase 25
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / 'chip_smoke.py'
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


CS = _chip_smoke()


def _good_artifact_run():
    return dict(
        manifest=['input data float32 8,3,224,224',
                  'output 0 float32 8,1000'],
        runner_rc=0, runner_err='', pt2_rel_err=0.0,
        rungs=[1, 8, 32], second_hits=3, second_misses=0,
        c_predict={'cpu': dict(rc=0, predicted=7, want=7, err=''),
                   'card': dict(rc=0, predicted=9, want=9, err='')},
        launches=dict(conv_bn_stats=0, flash_fwd=0, flash_bwd_dkdv=0,
                      flash_bwd_dq=0, rtc=0))


def test_artifact_gate_passes_a_good_run():
    assert CS.artifact_gate(_good_artifact_run()) == []


@pytest.mark.parametrize('edit, word', [
    (lambda r: r['manifest'].pop(), 'manifest'),
    (lambda r: r.update(runner_rc=1), 'runner'),
    (lambda r: r.update(pt2_rel_err=0.5), 'Predictor.forward'),
    (lambda r: r.update(rungs=[1, 8]), 'rungs'),
    (lambda r: r.update(second_hits=2), 'second'),
    (lambda r: r.update(second_misses=1), 'second'),
    (lambda r: r['c_predict']['card'].update(predicted=3), 'card'),
    (lambda r: r['c_predict']['cpu'].update(rc=1), 'cpu'),
    (lambda r: r['launches'].update(flash_fwd=24), 'flash_fwd'),
])
def test_artifact_gate_fails_a_bad_run(edit, word):
    run = _good_artifact_run()
    edit(run)
    bad = CS.artifact_gate(run)
    assert bad and any(word in b for b in bad), bad
