"""The examples with a quick mode (every `main(quick=True)` that
tests/test_examples.py runs on the JAX package), unedited, on the port
on the CPU.

Each runs in a child interpreter (tests/_torch_examples_child.py)
through the finder of mxnet_tpu_torch.tools.run_script, where
`mxnet_tpu` is the port: in this process it is the JAX package. The
gates are those of tests/test_examples.py, example by example, and so
are the `slow` marks. The examples outside the slow set share one
child; each slow one has its own.
"""
import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, 'tests', '_torch_examples_child.py')

FAST = ('examples/recommender/matrix_factorization.py',
        'examples/neural_style/neural_style.py',
        'examples/numpy_ops/custom_softmax.py',
        'examples/multi_task/multi_task.py',
        'examples/csv_tabular/csv_train.py',
        'examples/profiling/profile_training.py',
        'examples/memcost/memcost.py',
        'examples/dsd/mlp_dsd.py')


def run_quick(tmp_path, rels, timeout):
    """{rel: {'result': ...} or {'error': traceback}} of the examples
    `rels` in one child, and the runner's report under '__report__'."""
    out = os.path.join(str(tmp_path), 'results.json')
    env = dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='1')
    proc = subprocess.run([sys.executable, CHILD, 'quick', out] + list(rels),
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as f:
        results = json.load(f)
    report = results['__report__']
    assert report['mxnet_tpu'] == 'mxnet_tpu_torch', report
    return results


def result(results, rel):
    entry = results[rel]
    assert 'error' not in entry, entry.get('error')
    return entry['result']


@pytest.fixture(scope='module')
def fast(tmp_path_factory):
    return run_quick(tmp_path_factory.mktemp('fast'), FAST, timeout=600)


def one(tmp_path, rel):
    return result(run_quick(tmp_path, [rel], timeout=1200), rel)


@pytest.mark.slow
def test_fgsm_adversary(tmp_path):
    clean, adv = one(tmp_path, 'examples/adversary/fgsm.py')
    assert clean > 0.9, clean
    assert adv < clean - 0.2, (clean, adv)


def test_matrix_factorization(fast):
    rmse, baseline = result(fast,
                            'examples/recommender/matrix_factorization.py')
    assert rmse < 0.6 * baseline, (rmse, baseline)


def test_neural_style(fast):
    first, last = result(fast, 'examples/neural_style/neural_style.py')
    assert last < 0.5 * first, (first, last)


@pytest.mark.slow
def test_finetune(tmp_path):
    """The JAX package's finetune.py raises at its set_params
    (mxnet_tpu/module/module.py: the new head's parameters are not in
    the frozen symbol, and allow_extra is not passed); the port raises
    the same error. Parity, pinned: ROADMAP, Findings in the JAX
    package."""
    import importlib.util
    import mxnet_tpu
    spec = importlib.util.spec_from_file_location(
        'ex_finetune_jax', os.path.join(REPO, 'examples/finetune/finetune.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(mxnet_tpu.base.MXNetError) as jax_err:
        mod.main(quick=True)
    rel = 'examples/finetune/finetune.py'
    port = run_quick(tmp_path, [rel], timeout=1200)[rel]
    assert 'error' in port, port
    port_msg = port['error'].strip().splitlines()[-1]
    assert port_msg.startswith('mxnet_tpu_torch.base.MXNetError'), port_msg
    assert 'allow_extra' in str(jax_err.value), jax_err.value
    names = re.findall(r"'(\w+)'", str(jax_err.value))
    assert names == re.findall(r"'(\w+)'", port_msg), (jax_err.value,
                                                        port_msg)


@pytest.mark.slow
def test_bi_lstm_sort(tmp_path):
    acc = one(tmp_path, 'examples/bi_lstm_sort/sort.py')
    assert acc > 0.8, acc


@pytest.mark.slow
def test_autoencoder(tmp_path):
    mse, var = one(tmp_path, 'examples/autoencoder/autoencoder.py')
    assert mse < 0.05 * var, (mse, var)


def test_numpy_custom_op(fast):
    acc = result(fast, 'examples/numpy_ops/custom_softmax.py')
    assert acc > 0.9, acc


def test_multi_task(fast):
    scores = result(fast, 'examples/multi_task/multi_task.py')
    assert scores['accuracy'] > 0.9, scores
    assert scores['rmse'] < 0.5, scores


@pytest.mark.slow
def test_sgld_regression(tmp_path):
    mu_err, sd, ratio = one(tmp_path,
                            'examples/bayesian_methods/sgld_regression.py')
    assert mu_err < 6 * sd, (mu_err, sd)
    assert 0.3 < ratio < 3.0, ratio


def test_csv_tabular(fast):
    acc = result(fast, 'examples/csv_tabular/csv_train.py')
    assert acc > 0.9, acc


def test_profiling_example(fast):
    spans, seen = result(fast, 'examples/profiling/profile_training.py')
    assert spans > 0, spans
    assert seen, seen


@pytest.mark.slow
def test_lstm_ocr_ctc(tmp_path):
    acc = one(tmp_path, 'examples/ctc/lstm_ocr.py')
    assert acc > 0.7, acc


@pytest.mark.slow
def test_fcn_segmentation(tmp_path):
    acc, bg = one(tmp_path, 'examples/fcn_xs/fcn_seg.py')
    assert acc > max(0.9, bg + 0.1), (acc, bg)


@pytest.mark.slow
def test_nce_word_vectors(tmp_path):
    prec = one(tmp_path, 'examples/nce_loss/nce_words.py')
    assert prec > 0.5, prec


@pytest.mark.slow
def test_cnn_text_classification(tmp_path):
    acc = one(tmp_path, 'examples/cnn_text/text_cnn.py')
    assert acc > 0.9, acc


@pytest.mark.slow
def test_actor_critic_rl(tmp_path):
    first, last = one(tmp_path,
                      'examples/reinforcement_learning/actor_critic.py')
    assert last > 0.7, (first, last)


@pytest.mark.slow
def test_faster_rcnn(tmp_path):
    rpn_recall, det_acc = one(tmp_path,
                              'examples/rcnn/train_faster_rcnn.py')
    assert rpn_recall > 0.8, rpn_recall
    assert det_acc > 0.7, det_acc


@pytest.mark.slow
def test_svm_mnist(tmp_path):
    acc_l2, acc_l1, margin = one(tmp_path, 'examples/svm_mnist/svm_mnist.py')
    assert acc_l2 > 0.9, acc_l2
    assert acc_l1 > 0.9, acc_l1
    assert margin > 0.7, margin


@pytest.mark.slow
def test_stochastic_depth(tmp_path):
    acc, gate_err, determ = one(tmp_path,
                                'examples/stochastic_depth/sd_mnist.py')
    assert acc > 0.9, acc
    assert gate_err < 0.15, gate_err
    assert determ == 0.0, determ


@pytest.mark.slow
def test_dec_clustering(tmp_path):
    init_acc, final_acc = one(tmp_path, 'examples/dec/dec.py')
    assert final_acc >= init_acc, (init_acc, final_acc)
    assert final_acc > 0.9, final_acc


def test_dec_matches_the_jax_package_at_equal_initial_weights(tmp_path):
    """examples/dec/dec.py's quick run with the weights Xavier would draw
    taken from numpy in both packages (tests/_torch_dec_equal_init.py):
    the port's k-means and DEC accuracies are the JAX package's. The
    example's own gate rests on its seeded draws, which the packages
    make differently (test_dec_clustering)."""
    import numpy as np
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    try:
        import _torch_dec_equal_init as user
        want = user.run(0)['accuracy']
    finally:
        sys.path.remove(os.path.join(REPO, 'tests'))
    out = os.path.join(str(tmp_path), 'port.npz')
    env = dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, CHILD, 'module', out,
         os.path.join(REPO, 'tests', '_torch_dec_equal_init.py'), '0'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = np.load(out)['accuracy']
    np.testing.assert_allclose(got, want, atol=1 / 600 + 1e-9)


@pytest.mark.slow
def test_captcha_ocr(tmp_path):
    digit_acc, seq_acc = one(tmp_path, 'examples/captcha/captcha_ocr.py')
    assert digit_acc > 0.93, digit_acc
    assert seq_acc > 0.8, seq_acc


def test_memcost(fast):
    """The CPU executor's memory_cost gives integers (the bytes of the
    storages alive at once), with the JAX package's gates."""
    fwd, bwd, remat = result(fast, 'examples/memcost/memcost.py')
    assert all(isinstance(v, int) for v in (fwd, bwd, remat)), \
        (fwd, bwd, remat)
    assert bwd > 2 * fwd, (fwd, bwd)
    assert remat <= bwd, (remat, bwd)


@pytest.mark.slow
def test_rnn_time_major(tmp_path):
    acc_nt, acc_tn, max_dev = one(
        tmp_path, 'examples/rnn_time_major/rnn_cell_demo.py')
    assert acc_nt > 0.9, acc_nt
    assert acc_tn > 0.9, acc_tn
    assert max_dev < 1e-5, max_dev


def test_dsd_training(fast):
    dense_acc, sparse_frac, sparse_acc, final_acc = result(
        fast, 'examples/dsd/mlp_dsd.py')
    assert sparse_frac > 0.65, sparse_frac
    assert sparse_acc > 0.9, sparse_acc
    assert final_acc > 0.9, final_acc
