"""The port's mx.image, io.ImageRecordIter and the input counters against
the JAX package's, on the CPU.

- imresize against the JAX package's (cv2.resize) on seeded uint8
  images at every interpolation (nearest, linear, cubic, area), up- and
  down-scales at fractional ratios: within 1 level (nearest equal), and
  float32 images within 1e-3.
- Each crop and augmenter on the same uint8 image and the same draws of
  `random` / `np.random`: equal, but ContrastJitterAug, whose grey level
  is a float32 sum over the image (numpy's pairwise order against
  torch's): within rtol 1e-6 / atol 1e-4.
- imdecode on cpu(0) equal to the JAX package's (both cv2), copyMakeBorder,
  scale_down and resize_short.
- ImageIter, ImageRecordIter and ImageDetIter batches against the JAX
  package's (use_native=False), the sequential path (preprocess_threads
  0) and the decode pool (2 and 4): equal where the chain does not
  resize, within 1 level (normalised by std) where it does; the labels
  equal. The parallel path equal for 2 and 4 workers.
- random.stream_seed equal to the JAX package's integers; the profiler's
  input counters and Module.fit's decode-worker wiring, as
  tests/test_image_pipeline.py holds the JAX package's.
- A cut ResNet Module step fed by ImageRecordIter against the JAX
  package's on the same batch: the batch equal, the loss and outputs
  within 1e-5.
- What the port refuses: use_native=True when the native runtime
  cannot be built (tests/test_torch_native.py runs it); a decode for
  the card with no CUDA raises, and nvJPEG without its library raises.
"""
import random as pyrandom

import numpy as np
import pytest

torch = pytest.importorskip('torch')
cv2 = pytest.importorskip('cv2')

import mxnet_tpu as jmx
from mxnet_tpu import image as jimage
from mxnet_tpu import models as jmodels
from mxnet_tpu import profiler as jprofiler
from mxnet_tpu import random as jrandom
from mxnet_tpu import recordio as jrecordio

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image, profiler, recordio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.image import _nvjpeg
from mxnet_tpu_torch.image import image as img_mod

from test_torch_models import _chip_smoke
from test_torch_resnet import CUT, F32_STATE, seeded_params

CPU = mx.cpu()


def _smooth_img(h, w, seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 1.5)


def _write_rec(path, n=14, fmt='.jpg', sides=(30, 52), seed=0,
               det=False):
    """A .rec/.idx pair of n seeded images (BGR, as cv2 encodes) with
    class labels, or detection labels packed as tools/im2rec.py packs
    them ([2, 5, cls, x1, y1, x2, y2, ...])."""
    rng = np.random.RandomState(seed)
    prefix = str(path / ('det' if det else 'data'))
    rec = jrecordio.MXIndexedRecordIO(prefix + '.idx', prefix + '.rec', 'w')
    for i in range(n):
        h, w = rng.randint(sides[0], sides[1], 2)
        img = _smooth_img(h, w, seed * 1000 + i)
        if det:
            objs = []
            for _ in range(rng.randint(1, 4)):
                x1, y1 = rng.uniform(0, 0.6, 2)
                bw, bh = rng.uniform(0.2, 0.4, 2)
                objs += [rng.randint(0, 3), x1, y1, x1 + bw, y1 + bh]
            label = np.array([2, 5] + objs, np.float32)
        else:
            label = float(i % 5)
        header = jrecordio.IRHeader(0, label, i, 0)
        rec.write_idx(i, jrecordio.pack_img(header, img, quality=95,
                                            img_fmt=fmt))
    rec.close()
    return prefix


def _epoch(it):
    it.reset()
    out = []
    while True:
        try:
            b = it.next()
        except StopIteration:
            break
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def _assert_epochs_close(got, ref, atol=0.0):
    assert len(got) == len(ref)
    for (dg, lg, pg), (dr, lr, pr) in zip(got, ref):
        assert dg.shape == dr.shape and pg == pr
        np.testing.assert_allclose(dg, dr, rtol=0, atol=atol)
        np.testing.assert_array_equal(lg, lr)


# ---------------------------------------------------------------------------
# pixels
# ---------------------------------------------------------------------------

RESIZE_SIZES = {'down': ((57, 83), (23, 31)), 'up': ((13, 19), (41, 50)),
                'mixed': ((40, 21), (17, 33)), 'down2': ((40, 60), (20, 30))}


@pytest.mark.parametrize('interp', [0, 1, 2, 3])
@pytest.mark.parametrize('direction', sorted(RESIZE_SIZES))
def test_imresize_within_one_level_of_jax(interp, direction):
    (h, w), (oh, ow) = RESIZE_SIZES[direction]
    for seed, smooth in ((0, False), (1, True)):
        img = _smooth_img(h, w, seed) if smooth else \
            np.random.RandomState(seed).randint(0, 256, (h, w, 3)) \
            .astype(np.uint8)
        ref = jimage.imresize(img, ow, oh, interp)
        got = image.imresize(img, ow, oh, interp)
        assert got.shape == ref.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - ref.astype(int)).max()
        assert diff <= (0 if interp == 0 else 1), diff
        f32 = img.astype(np.float32)
        np.testing.assert_allclose(image.imresize(f32, ow, oh, interp),
                                   jimage.imresize(f32, ow, oh, interp),
                                   rtol=0, atol=1e-3)


def test_imresize_ndarray_stays_on_its_context():
    img = mx.nd.array(_smooth_img(20, 30, 0), ctx=CPU, dtype=np.uint8)
    out = image.imresize(img, 12, 9, 2)
    assert isinstance(out, mx.nd.NDArray) and out.context == CPU
    assert out.shape == (9, 12, 3) and out.dtype == np.uint8


def _draws(seed):
    pyrandom.seed(seed)
    np.random.seed(seed)


AUGMENTERS = {
    'resize': lambda m: m.ResizeAug(21, 2),
    'force_resize': lambda m: m.ForceResizeAug((25, 17), 1),
    'random_crop': lambda m: m.RandomCropAug((20, 16), 2),
    'random_crop_scaled': lambda m: m.RandomCropAug((60, 50), 2),
    'random_sized_crop': lambda m: m.RandomSizedCropAug(
        (18, 18), 0.3, (0.75, 1.33), 2),
    'center_crop': lambda m: m.CenterCropAug((24, 20), 2),
    'flip': lambda m: m.HorizontalFlipAug(1.0),
    'cast': lambda m: m.CastAug(),
    'brightness': lambda m: m.BrightnessJitterAug(0.4),
    'contrast': lambda m: m.ContrastJitterAug(0.4),
    'saturation': lambda m: m.SaturationJitterAug(0.4),
    'color_jitter': lambda m: m.ColorJitterAug(0.3, 0.0, 0.3),
    'lighting': lambda m: m.LightingAug(0.1, *img_mod.IMAGENET_PCA),
    'normalize': lambda m: m.ColorNormalizeAug(
        np.array([123.68, 116.28, 103.53]), np.array([58.4, 57.1, 57.4])),
    'random_order': lambda m: m.RandomOrderAug(
        [m.BrightnessJitterAug(0.2), m.SaturationJitterAug(0.2)]),
}
# resizing ones are within a level; the contrast jitter sums the image
AUG_TOL = {'resize': 1, 'force_resize': 1, 'random_crop_scaled': 1,
           'random_sized_crop': 1}


@pytest.mark.parametrize('name', sorted(AUGMENTERS))
def test_augmenter_matches_jax(name):
    img = _smooth_img(37, 45, 3)
    for seed in range(3):
        _draws(seed)
        ref = AUGMENTERS[name](jimage)(img)[0]
        _draws(seed)
        got = AUGMENTERS[name](image)(img)[0]
        ref = np.asarray(ref)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        if name == 'contrast':
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)
        else:
            diff = np.abs(got.astype(np.float64) - ref).max()
            assert diff <= AUG_TOL.get(name, 0), diff


@pytest.mark.parametrize('fn', ['fixed', 'random', 'center', 'sized'])
def test_crops_match_jax(fn):
    img = _smooth_img(40, 50, 1)
    calls = {
        'fixed': lambda m: (m.fixed_crop(img, 3, 5, 20, 17),
                            m.fixed_crop(img, 3, 5, 20, 17, (10, 9), 1)),
        'random': lambda m: m.random_crop(img, (24, 20)),
        'center': lambda m: m.center_crop(img, (60, 45)),
        'sized': lambda m: m.random_size_crop(img, (16, 16), 0.3,
                                              (0.75, 1.33)),
    }
    _draws(7)
    ref = calls[fn](jimage)
    _draws(7)
    got = calls[fn](image)
    # the crops that resize are within a level, the others equal
    tol = {'fixed': (0, 1), 'random': (0, 0)}.get(fn, (1, 0))
    for g, r, t in zip(got, ref, tol):
        if isinstance(r, tuple):
            assert g == r
        else:
            assert np.abs(g.astype(int) - np.asarray(r).astype(int)).max() \
                <= t


def test_imdecode_on_the_cpu_equals_jax():
    img = _smooth_img(33, 41, 2)
    for fmt in ('.jpg', '.png'):
        ok, buf = cv2.imencode(fmt, img)
        for flag, to_rgb in ((1, True), (1, False), (0, True)):
            ref = jimage.imdecode(buf.tobytes(), flag=flag, to_rgb=to_rgb)
            got = image.imdecode(buf.tobytes(), flag=flag, to_rgb=to_rgb,
                                 ctx=CPU)
            assert got.context == CPU
            np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())
    with CPU:
        assert image.imdecode(buf.tobytes()).context == CPU


def test_border_scale_down_resize_short_match_jax():
    img = _smooth_img(20, 31, 4)
    np.testing.assert_array_equal(
        image.copyMakeBorder(img, 2, 3, 4, 5, value=7),
        jimage.image.copyMakeBorder(img, 2, 3, 4, 5, value=7))
    for src, size in (((50, 40), (60, 30)), ((30, 80), (20, 20)),
                      ((100, 100), (120, 240))):
        assert image.scale_down(src, size) == jimage.scale_down(src, size)
    got = image.resize_short(img, 13)
    ref = jimage.resize_short(img, 13)
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_array_equal(
        image.color_normalize(img, [1.0, 2.0, 3.0], [2.0, 4.0, 8.0]),
        jimage.color_normalize(img, [1.0, 2.0, 3.0], [2.0, 4.0, 8.0]))


def test_create_augmenter_matches_jax():
    kw = dict(resize=40, rand_crop=True, rand_resize=True,
              rand_mirror=True, mean=True, std=True, brightness=0.1,
              contrast=0.1, saturation=0.1, pca_noise=0.1)
    mine = image.CreateAugmenter((3, 32, 32), **kw)
    theirs = jimage.CreateAugmenter((3, 32, 32), **kw)
    assert [type(a).__name__ for a in mine] == \
        [type(a).__name__ for a in theirs]


# ---------------------------------------------------------------------------
# iterators
# ---------------------------------------------------------------------------

ITER_CASES = {
    # name: (ImageIter kwargs, whether the chain resizes)
    'crop_mirror': (dict(rand_crop=True, rand_mirror=True,
                         mean=np.array([123.0, 117.0, 104.0])), False),
    'resize_center': (dict(resize=28, mean=True, std=True), True),
    'sized_crop': (dict(rand_crop=True, rand_resize=True, std=True,
                        mean=True), True),
}


@pytest.mark.parametrize('threads', [0, 2, 4])
@pytest.mark.parametrize('case', sorted(ITER_CASES))
def test_image_iter_matches_jax(tmp_path, case, threads):
    kw, resizes = ITER_CASES[case]
    prefix = _write_rec(tmp_path)
    epochs = []
    for pkg, extra in ((jimage, {}), (image, dict(ctx=CPU))):
        _draws(11)
        pkg_random = jrandom if pkg is jimage else mx.random
        pkg_random.seed(5)
        it = pkg.ImageIter(batch_size=4, data_shape=(3, 24, 24),
                           path_imgrec=prefix + '.rec', shuffle=True,
                           preprocess_threads=threads, **extra, **kw)
        epochs.append(_epoch(it) + _epoch(it))
        it.close()
    # std normalises by about 57: a level of the resize is 1 / 57 there
    _assert_epochs_close(epochs[1], epochs[0],
                         atol=1.0 + 1e-4 if resizes else 1e-4)


def test_parallel_epochs_equal_for_any_worker_count(tmp_path):
    prefix = _write_rec(tmp_path)
    runs = []
    for threads in (2, 4):
        mx.random.seed(3)
        pyrandom.seed(0)
        it = image.ImageIter(batch_size=5, data_shape=(3, 20, 20),
                             path_imgrec=prefix + '.rec', shuffle=True,
                             rand_crop=True, rand_mirror=True,
                             preprocess_threads=threads, ctx=CPU)
        runs.append(_epoch(it))
        it.close()
    _assert_epochs_close(runs[1], runs[0])


@pytest.mark.parametrize('threads', [0, 2, 4])
def test_image_record_iter_matches_jax(tmp_path, threads):
    prefix = _write_rec(tmp_path, fmt='.png')
    epochs = []
    for pkg in (jmx, mx):
        _draws(2)
        (jrandom if pkg is jmx else mx.random).seed(1)
        extra = dict(use_native=False) if pkg is jmx else dict(ctx=CPU)
        it = pkg.io.ImageRecordIter(
            path_imgrec=prefix + '.rec', data_shape=(3, 24, 24),
            batch_size=4, shuffle=True, rand_crop=True, rand_mirror=True,
            mean_r=123.0, mean_g=117.0, mean_b=104.0, std_r=58.0,
            std_g=57.0, std_b=57.5, preprocess_threads=threads, **extra)
        epochs.append(_epoch(it))
        it._inner.close()
    _assert_epochs_close(epochs[1], epochs[0], atol=1e-4)


def test_image_record_iter_mean_img_and_resize(tmp_path):
    """mean_img with resize against the JAX package's ImageIter over the
    chain its ImageRecordIter builds (CreateAugmenter, then the mean
    image subtracted): the JAX ImageRecordIter's own mean_img path fails
    to import its helpers (mxnet_tpu/io.py:687) and its prefetch thread
    then never ends, so it cannot be the reference here."""
    prefix = _write_rec(tmp_path, n=6)
    mean = np.random.RandomState(0).rand(3, 20, 20).astype(np.float32) * 50
    mx.nd.save(str(tmp_path / 'mean.nd'), [mx.nd.array(mean, ctx=CPU)])

    class MeanImage(jimage.Augmenter):
        def __call__(self, src):
            return [np.asarray(src, np.float32) - mean.transpose(1, 2, 0)]
    _draws(4)
    augs = jimage.CreateAugmenter((3, 20, 20), resize=26) + [MeanImage()]
    ref = _epoch(jimage.ImageIter(batch_size=3, data_shape=(3, 20, 20),
                                  path_imgrec=prefix + '.rec',
                                  aug_list=augs, preprocess_threads=0))
    _draws(4)
    it = mx.io.ImageRecordIter(
        path_imgrec=prefix + '.rec', data_shape=(3, 20, 20), batch_size=3,
        resize=26, mean_img=str(tmp_path / 'mean.nd'), preprocess_threads=0,
        ctx=CPU)
    _assert_epochs_close(_epoch(it), ref, atol=1.0 + 1e-4)


def test_image_record_iter_refuses_the_native_pipeline(tmp_path,
                                                      monkeypatch):
    """use_native=True with a native runtime that cannot be built
    raises, naming the failure, and makes no Python pipeline in its
    place; mean_img, which the native pipeline does not take, is
    refused beside it."""
    from mxnet_tpu_torch import _build, _core
    prefix = _write_rec(tmp_path, n=2)
    with pytest.raises(ValueError, match='mean_img'):
        mx.io.ImageRecordIter(path_imgrec=prefix + '.rec',
                              data_shape=(3, 8, 8), batch_size=1,
                              mean_img='mean.nd', use_native=True, ctx=CPU)

    def broken():
        raise RuntimeError('OpenCV 4 not found')
    monkeypatch.setattr(_build, 'native_image_library', broken)
    monkeypatch.setattr(_core, '_LIBS', {})
    with pytest.raises(_core.NativeError, match='OpenCV 4 not found'):
        mx.io.ImageRecordIter(path_imgrec=prefix + '.rec',
                              data_shape=(3, 8, 8), batch_size=1,
                              use_native=True, ctx=CPU)


@pytest.mark.parametrize('threads', [0, 2, 4])
def test_image_det_iter_matches_jax(tmp_path, threads):
    prefix = _write_rec(tmp_path, n=10, det=True, sides=(40, 70))
    epochs = []
    for pkg, extra in ((jimage, {}), (image, dict(ctx=CPU))):
        _draws(9)
        (jrandom if pkg is jimage else mx.random).seed(2)
        it = pkg.ImageDetIter(batch_size=4, data_shape=(3, 30, 30),
                              path_imgrec=prefix + '.rec', shuffle=True,
                              rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
                              mean=True, std=True,
                              preprocess_threads=threads, **extra)
        assert it.max_objects == 3
        epochs.append(_epoch(it))
        it.close()
    _assert_epochs_close(epochs[1], epochs[0], atol=1.0 + 1e-4)


def test_det_augmenters_match_jax():
    from mxnet_tpu.image import detection as jdet
    from mxnet_tpu_torch.image import detection as det
    img = _smooth_img(40, 48, 5)
    label = np.array([[1, 0.1, 0.2, 0.5, 0.6], [0, 0.4, 0.4, 0.9, 0.8],
                      [-1, -1, -1, -1, -1]], np.float32)
    for make in (lambda m: m.DetHorizontalFlipAug(1.0),
                 lambda m: m.DetRandomCropAug(min_object_covered=0.3),
                 lambda m: m.DetRandomPadAug(pad_val=(1, 2, 3))):
        for seed in range(3):
            _draws(seed)
            ri, rl = make(jdet)(img, label)
            _draws(seed)
            gi, gl = make(det)(img, label)
            np.testing.assert_array_equal(np.asarray(gi), np.asarray(ri))
            np.testing.assert_array_equal(gl, rl)
    raw = np.array([2, 6, 1, 0.1, 0.2, 0.3, 0.4, 9, 2, 0.5, 0.5, 0.6, 0.7,
                    9], np.float32)
    np.testing.assert_array_equal(det._parse_det_label(raw, 5),
                                  jdet._parse_det_label(raw, 5))


def test_stream_seed_equals_jax():
    for seed in (0, 7, 123456):
        jrandom.seed(seed)
        mx.random.seed(seed)
        for comps in (('image-aug', 0, 0), ('image-aug', 3, 1041), ('x',)):
            assert mx.random.stream_seed(*comps) == \
                jrandom.stream_seed(*comps)


# ---------------------------------------------------------------------------
# counters and Module.fit's wiring (tests/test_image_pipeline.py:363, :391)
# ---------------------------------------------------------------------------

def test_profiler_input_counters(tmp_path):
    prefix = _write_rec(tmp_path, n=12)
    profiler.clear()
    it = image.ImageIter(batch_size=4, data_shape=(3, 16, 16),
                         path_imgrec=prefix + '.rec', preprocess_threads=3,
                         ctx=CPU)
    _epoch(it)
    it.close()
    st = profiler.input_stats()
    assert st['decoded_samples'] >= 12
    assert st['decode_ms'] > 0
    assert st['queue_depth_obs'] > 0
    text = profiler.summary(print_out=False)
    assert 'decode_ms' in text and 'queue_depth_avg' in text
    assert set(st) == set(jprofiler.input_stats())


def test_prefetch_to_device_feeds_the_stall_counter():
    profiler.clear()
    x = np.random.RandomState(0).rand(8, 3).astype(np.float32)
    y = np.arange(8, dtype=np.float32)
    with CPU:
        pf = mx.io.prefetch_to_device(mx.io.NDArrayIter(x, y, batch_size=4),
                                      size=2, device=CPU)
        list(pf)
    st = profiler.input_stats()
    assert st['input_batches'] == 2
    assert st['input_stall_ms'] >= 0


def test_fit_wires_decode_workers(tmp_path, monkeypatch):
    prefix = _write_rec(tmp_path, n=12)
    monkeypatch.delenv('MXNET_TPU_DECODE_WORKERS', raising=False)
    it = image.ImageIter(batch_size=4, data_shape=(3, 16, 16),
                         path_imgrec=prefix + '.rec', ctx=CPU)
    assert it.preprocess_threads == 0 and it._workers_explicit is False
    monkeypatch.setenv('MXNET_TPU_DECODE_WORKERS', '3')
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Variable('data'), num_hidden=4), name='softmax')
    mod = mx.mod.Module(net, context=CPU)
    mod._wrap_train_iter(it)
    assert it.preprocess_threads == 3
    it2 = image.ImageIter(batch_size=4, data_shape=(3, 16, 16),
                          path_imgrec=prefix + '.rec', preprocess_threads=0,
                          ctx=CPU)
    mod._wrap_train_iter(it2)
    assert it2.preprocess_threads == 0
    it.close()


# ---------------------------------------------------------------------------
# the ImageRecordIter -> ResNet path
# ---------------------------------------------------------------------------

RESNET_STEP_OPT = dict(learning_rate=0.1 * 4 / 256, momentum=0.9, wd=1e-4)


def _float64_step(args, auxs, x, y):
    """The first momentum-SGD step of the cut ResNet in float64 (the
    port's executor bound at float64): each weight w - lr (g / batch +
    wd w)."""
    symbol = mx.models.resnet.resnet(**CUT)
    req = {n: 'null' if n in ('data', 'softmax_label') else 'write'
           for n in symbol.list_arguments()}
    ex = symbol.simple_bind(mx.cpu(), grad_req=req,
                            type_dict={n: np.float64 for n in req},
                            data=x.shape)
    for k, v in dict(args, data=x, softmax_label=y).items():
        ex.arg_dict[k][:] = v.astype(np.float64)
    for k, v in auxs.items():
        ex.aux_dict[k][:] = v.astype(np.float64)
    ex.forward_backward()
    lr, wd = RESNET_STEP_OPT['learning_rate'], RESNET_STEP_OPT['wd']
    return {k: args[k] - lr * (ex.grad_dict[k].asnumpy() / x.shape[0] +
                               wd * args[k].astype(np.float64))
            for k in args}


def test_image_record_iter_feeds_a_resnet_step_as_jax(tmp_path):
    """The cut ResNet of tests/test_torch_resnet.py (float32, seeded
    He-normal weights) takes one Module step (momentum SGD) on the first
    ImageRecordIter batch, in both packages: the batch equal, the outputs
    within rtol 1e-5 / atol 1e-6, the moving statistics within F32_STATE
    (what tests/test_torch_module.py holds the cut ResNet's Module steps
    to), and each weight within F32_STATE of the same step in float64.
    Against the JAX package's weights the bound is F32_STATE plus the JAX
    package's own distance from the float64 step: on these un-centred,
    smooth images its float32 gradients are 0.04 from float64's (1.4 % of
    the largest), the port's 1e-5 (ROADMAP Queue C)."""
    prefix = _write_rec(tmp_path, n=8, sides=(70, 90))
    shape = CUT['image_shape']
    symbol = jmodels.resnet.resnet(**CUT)
    args, auxs = seeded_params(symbol, dict(data=(4,) + shape), seed=0)
    args = {k: v for k, v in args.items()
            if k not in ('data', 'softmax_label')}
    batches, outs, states = [], [], []
    for pkg in (jmx, mx):
        _draws(6)
        ctx = pkg.cpu()
        extra = dict(use_native=False) if pkg is jmx else dict(ctx=ctx)
        it = pkg.io.ImageRecordIter(
            path_imgrec=prefix + '.rec', data_shape=shape, batch_size=4,
            rand_crop=True, rand_mirror=True, mean_r=123.0, mean_g=117.0,
            mean_b=104.0, std_r=58.0, std_g=57.0, std_b=57.5,
            preprocess_threads=0, **extra)
        batch = it.next()
        batches.append((batch.data[0].asnumpy(), batch.label[0].asnumpy()))
        models = jmodels if pkg is jmx else mx.models
        mod = pkg.mod.Module(models.resnet.resnet(**CUT), context=ctx)
        mod.bind(data_shapes=it.provide_data,
                 label_shapes=it.provide_label)
        mod.set_params({k: pkg.nd.array(v, ctx=ctx) for k, v in args.items()},
                       {k: pkg.nd.array(v, ctx=ctx) for k, v in auxs.items()})
        mod.init_optimizer(optimizer='sgd',
                           optimizer_params=dict(RESNET_STEP_OPT))
        mod.forward_backward(batch)
        outs.append(mod.get_outputs()[0].asnumpy())
        mod.update()
        arg, aux = mod.get_params()
        states.append(({k: v.asnumpy() for k, v in arg.items()},
                       {k: v.asnumpy() for k, v in aux.items()}))
    np.testing.assert_array_equal(batches[1][0], batches[0][0])
    np.testing.assert_array_equal(batches[1][1], batches[0][1])
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)
    (jarg, jaux), (targ, taux) = states
    assert sorted(targ) == sorted(jarg) and sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k], jaux[k], err_msg=k, **F32_STATE)
    exact = _float64_step(args, auxs, *batches[1])
    for k in jarg:
        np.testing.assert_allclose(targ[k], exact[k], err_msg=k,
                                   **F32_STATE)
        jax_off = np.abs(jarg[k] - exact[k])
        bound = F32_STATE['atol'] + F32_STATE['rtol'] * np.abs(jarg[k])
        assert (np.abs(targ[k] - jarg[k]) <= bound + jax_off).all(), k


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------

def test_no_quiet_fallback_for_the_card(tmp_path, monkeypatch):
    ok, buf = cv2.imencode('.jpg', _smooth_img(16, 16, 0))
    if not torch.cuda.is_available():
        with pytest.raises(Exception):
            image.imdecode(buf.tobytes(), ctx=mx.gpu(0))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    with pytest.raises(MXNetError, match='libnvjpeg'):
        _nvjpeg.library_path()


def test_pack_img_on_the_host_equals_jax():
    img = _smooth_img(21, 30, 8)
    header = recordio.IRHeader(0, 3.0, 7, 0)
    for fmt in ('.jpg', '.png'):
        assert recordio.pack_img(header, img, quality=90, img_fmt=fmt) == \
            jrecordio.pack_img(header, img, quality=90, img_fmt=fmt)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 18 gate
# ---------------------------------------------------------------------------

def test_phase18_gate_passes_a_good_run_and_refuses_bad_ones():
    cs = _chip_smoke()
    run = dict(stem_split=True, train_launches=[32] * 12, score_launches=0,
               score_finite=True, score=[('accuracy', 0.0)],
               step_check=dict(equal=True, unequal=[]),
               decode=dict(min_psnr_db=41.3),
               augment=dict(crop_mirror=dict(max_abs_diff=0.0),
                            resize_crop_mirror=dict(max_abs_diff=1.0)),
               workers_equal=True, finite=True,
               kernel_checks=[dict(ok=True, x=[1], w=[1])])
    assert cs.record_gate(run) == []

    def bad(**kw):
        return cs.record_gate(dict(run, **kw))
    assert bad(train_launches=[32] * 11 + [33])
    assert bad(stem_split=False)            # 33 expected without the split
    assert bad(score_launches=1)
    assert bad(score_finite=False)
    assert bad(step_check=dict(equal=False, unequal=['arg w']))
    assert bad(decode=dict(min_psnr_db=29.9))
    assert bad(augment=dict(run['augment'],
                            crop_mirror=dict(max_abs_diff=1.0)))
    assert bad(augment=dict(run['augment'],
                            resize_crop_mirror=dict(max_abs_diff=2.0)))
    assert bad(workers_equal=False)
    assert bad(finite=False)
    assert bad(kernel_checks=[dict(ok=False, x=[1], w=[1])])


def test_phase18_epoch_rate_counts_the_reset_and_the_refill():
    cs = _chip_smoke()
    times = [(0, 1.0), (0, 1.2), (1, 2.0), (1, 3.2), (2, 3.4), (2, 4.2)]
    assert cs.epoch_images_per_s(times, 100) == pytest.approx([50.0, 100.0])
