"""chip_smoke.py's phases 37 (the native runtime) and 38 (the C training
API) on the CPU: their checks pass a good run and fail each fault planted
in it. Phase 37: a reset that drops a batch, an engine program that ends
apart, a fit step whose launches go uncounted, a loss that does not fall,
a RecordIO read that differs. Phase 38, rehearsed with the real C program
at a tiny width (dev_type 1, a cut bf16 ResNet, batch 2): the program
against the same calls made in this process, and their replay past the
C API against the program, pass; a program that skips one weight's
update fails, and so do a loss head whose launches go uncounted, a
replay apart from the program, and two runs here that differ with no
nondeterministic kernel named; with one named, phase 36's bounds fail a
loss apart, the replay apart and the skipped update; batches from the
port's pipeline (a host without OpenCV) pass as the native iterator's
do."""
import copy
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')
cv2 = pytest.importorskip('cv2')

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _build, cuda_conv
from mxnet_tpu_torch import recordio as rec

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', REPO / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


def _records(path, n=12, sides=(40, 70)):
    prefix = str(path / 'imgs')
    w = rec.MXIndexedRecordIO(prefix + '.idx', prefix + '.rec', 'w')
    rs = np.random.RandomState(0)
    for i in range(n):
        h, wd = rs.randint(sides[0], sides[1], 2)
        ok, buf = cv2.imencode('.jpg', rs.randint(0, 255, (h, wd, 3))
                               .astype(np.uint8))
        assert ok
        w.write_idx(i, rec.pack(rec.IRHeader(0, float(i % 10), i, 0),
                                buf.tobytes()))
    w.close()
    return prefix


# -- phase 37 --------------------------------------------------------------------

def _native_run():
    want = CS.route_pairs(CS.RESNET_PAIRS, CS.stem_split_on())
    steps = 3 * CS.NATIVE_EPOCHS
    return dict(
        engine=dict(native=True, serial=True, read_write=True,
                    duplicates_refused=3,
                    programs=[dict(seed=0, equal=True),
                              dict(seed=1, equal=True)]),
        recordio=dict(c_to_py=True, py_to_c=True, same_bytes=True),
        image=dict(built=True),
        resets=dict(equal=[True] * CS.NATIVE_RESETS, batches=3),
        fit=dict(launches=[want] * steps, want=want, batches_an_epoch=3,
                 losses=[6.95, 6.93, 6.94, 6.80, 6.78, 6.79], finite=True))


def _uncounted_step(run):
    run['fit']['launches'][2] -= 1


def _engine_apart(run):
    run['engine']['programs'][1]['equal'] = False


def _loss_flat(run):
    run['fit']['losses'] = [6.9] * len(run['fit']['losses'])


def _recordio_differs(run):
    run['recordio']['py_to_c'] = False


def _reset_skipped(run):
    run['resets']['equal'] = run['resets']['equal'][:-1]


def test_phase_37_gate_passes_a_good_run():
    assert CS.native_gate(_native_run()) == []


@pytest.mark.parametrize('fault', [_uncounted_step, _engine_apart, _loss_flat,
                                   _recordio_differs, _reset_skipped])
def test_phase_37_gate(fault):
    run = _native_run()
    fault(run)
    assert CS.native_gate(run), fault.__name__


def test_phase_37_gate_without_opencv():
    """No image library: the gate holds the engine and RecordIO checks
    and the refusal, which must name OpenCV."""
    run = _native_run()
    for key in ('resets', 'fit'):
        del run[key]
    run['image'] = dict(built=False, error='OpenCV 4 not found',
                        refused='the native image iterator cannot be '
                                'built or loaded: OpenCV 4 not found')
    assert CS.native_gate(run) == []
    run['image']['refused'] = ''
    assert CS.native_gate(run)
    run['image']['refused'] = 'OpenCV 4 not found'
    run['engine']['serial'] = False
    assert CS.native_gate(run)


def test_phase_37_engine_and_recordio_checks(tmp_path):
    eng = CS.engine_checks(mx)
    io_ = CS.recordio_checks(mx, tmp_path)
    run = _native_run()
    run.update(engine=eng, recordio=io_)
    assert CS.native_gate(run) == [], (eng, io_)
    assert eng['native'] and len(eng['programs']) == 2


class _DropsABatch:
    """A native iterator whose resets after the first lose the epoch's
    first batch."""

    def __init__(self, it):
        self.it, self.resets = it, 0

    def reset(self):
        self.it.reset()
        self.resets += 1
        if self.resets > 1:
            self.it.next()

    def next(self):
        return self.it.next()

    def __iter__(self):
        return iter(self.it)


def test_phase_37_resets_on_the_native_iterator(tmp_path):
    prefix = _records(tmp_path)

    def make():
        return mx.io.ImageRecordIter(
            path_imgrec=prefix + '.rec', data_shape=(3, 32, 32),
            batch_size=4, use_native=True, preprocess_threads=8,
            ctx=mx.cpu())
    it = make()
    good = CS.reset_check(torch, it, resets=6)
    it.close()
    assert good['batches'] == 3 and all(good['equal'])
    run = _native_run()
    run['resets'] = dict(good, equal=good['equal'] + [True] *
                         (CS.NATIVE_RESETS - 6))
    assert CS.native_gate(run) == []

    it = make()
    bad = CS.reset_check(torch, _DropsABatch(it), resets=3)
    it.close()
    run['resets'] = dict(bad, equal=bad['equal'] + [True] *
                         (CS.NATIVE_RESETS - 3))
    assert not any(bad['equal'])
    assert CS.native_gate(run)


def test_phase_37_fit_fed_by_the_native_iterator(tmp_path, monkeypatch):
    """native_fit at a cut width on the CPU: Module.fit on a cut bf16
    ResNet fed by ImageRecordIter(use_native=True), a pair call counted
    for each routed pair of each step."""
    prefix = _records(tmp_path, n=8, sides=(64, 90))
    monkeypatch.setattr(CS, 'RESNET', dict(CS.RESNET, image_shape='3,64,64'))
    monkeypatch.setattr(CS, 'RESNET_BATCH', 4)
    monkeypatch.setattr(CS, 'module_symbol_params', lambda mx: (
        mx.models.resnet.resnet(dtype='bfloat16', **CS.CUT_RESNET),
        mx.init.Xavier(rnd_type='gaussian', factor_type='in', magnitude=2)))
    with mx.cpu():
        fit = CS.native_fit(
            torch, mx, cuda_conv, prefix, mx.cpu(),
            lambda: cuda_conv.CONV_BN_STATS_PLAIN_CALLS)
    assert fit['want'] == CS.CUT_RESNET_PAIRS - 1      # the stem split
    assert fit['batches_an_epoch'] == 2
    assert fit['launches'] == [fit['want']] * 2 * CS.NATIVE_EPOCHS
    assert fit['finite'] and all(np.isfinite(fit['losses']))


# -- phase 38 --------------------------------------------------------------------

def _c_train(tmp_path, skip=None, source='native'):
    root = tmp_path / 'root'
    (root / 'build').mkdir(parents=True)
    prefix = _records(tmp_path)
    net = mx.models.resnet.resnet(dtype='bfloat16', **CS.CUT_RESNET)
    with mx.cpu():
        started = CS.c_train_start(
            mx, root, prefix, _build.c_predict_library(), source=source,
            dev_type=1, steps=2, batch=2, image_shape=(3, 40, 40), net=net,
            skip=skip, classes=CS.CUT_RESNET['num_classes'])
        return CS.c_train_run(
            torch, mx, cuda_conv, started,
            counter=lambda: cuda_conv.CONV_BN_STATS_PLAIN_CALLS)


@pytest.fixture(scope='module')
def c_train_good(tmp_path_factory):
    return _c_train(tmp_path_factory.mktemp('c_train'))


@pytest.fixture(scope='module')
def c_train_skipped(tmp_path_factory):
    """The program skips the first weight's update in its last step."""
    return _c_train(tmp_path_factory.mktemp('c_train_skip'), skip=1)


def test_phase_38_program_equals_the_in_process_calls(c_train_good):
    run = c_train_good
    assert CS.c_train_gate(run) == [], run
    cmp_ = run['compare']
    assert cmp_['deterministic'] and cmp_['labels_equal']
    for what in ('program', 'replay'):
        assert cmp_[what]['data_equal'] and cmp_[what]['outputs_equal'] \
            and cmp_[what]['weights_equal'], what
    assert run['want_launches'] == CS.CUT_RESNET_PAIRS
    assert run['inprocess']['first']['launches'] == \
        run['want_launches'] * run['steps'] == run['replay']['launches']


def test_phase_38_from_the_ports_pipeline(tmp_path):
    """Batches from the port's pipeline on a context (the card's path on a
    host without OpenCV), here cpu(0)."""
    run = _c_train(tmp_path, source='cpu(0)')
    assert CS.c_train_gate(run) == [], run
    assert run['source'] == 'cpu(0)' and \
        run['compare']['program']['outputs_equal']


def test_phase_38_a_skipped_update_fails(c_train_skipped):
    run = c_train_skipped
    bad = CS.c_train_gate(run)
    assert len(bad) == 2 and 'program' in bad[0] and 'replay' in bad[1], bad
    for what in ('program', 'replay'):
        c = run['compare'][what]
        assert c['outputs_equal'] and not c['weights_equal'], what
        assert c['weights_rel'] > CS.MODULE_STATE_REL, what


def test_phase_38_uncounted_launches_fail(c_train_good):
    run = copy.deepcopy(c_train_good)
    run['inprocess']['first']['launches'] -= 1
    assert CS.c_train_gate(run)
    run = copy.deepcopy(c_train_good)
    run['replay']['launches'] -= 1
    assert CS.c_train_gate(run)


def _replay_apart(run):
    """The replay's weights apart from the program's: the mark a fault
    in the C API's bridge leaves, which both runs through it share."""
    run['compare']['replay'].update(weights_equal=False,
                                    weights_rel=10 * CS.MODULE_STATE_REL)


def test_phase_38_a_bridge_fault_fails_the_replay(c_train_good):
    run = copy.deepcopy(c_train_good)
    _replay_apart(run)
    assert CS.c_train_gate(run)


def test_phase_38_nondeterministic_runs_fail_unless_a_kernel_is_named(
        c_train_good):
    run = copy.deepcopy(c_train_good)
    run['compare']['deterministic'] = False
    bad = CS.c_train_gate(run)
    assert bad and 'no nondeterministic kernel is named' in bad[0], bad
    run['nondeterministic_kernel'] = 'a kernel'
    assert CS.c_train_gate(run) == []


@pytest.mark.parametrize('fault', ['loss', 'replay', 'skipped'])
def test_phase_38_named_kernel_holds_phase_36s_bounds(c_train_good,
                                                      c_train_skipped,
                                                      fault):
    """With a nondeterministic kernel named, the losses are held within
    RESNET_LOSS_ATOL and each weight array within MODULE_STATE_REL in
    relative norm: a loss apart, the replay apart and the skipped update
    each fail."""
    run = copy.deepcopy(c_train_skipped if fault == 'skipped'
                        else c_train_good)
    run['compare']['deterministic'] = False
    run['nondeterministic_kernel'] = 'a kernel'
    if fault == 'loss':
        run['compare']['program']['losses'][1] += 10 * CS.RESNET_LOSS_ATOL
    elif fault == 'replay':
        _replay_apart(run)
    assert CS.c_train_gate(run), fault
