"""The examples with no quick mode, unedited, on the port on the CPU:
the recurrent, Gluon, GAN and distributed ones (the image-classification
ones and SSD are in tests/test_torch_examples_cli.py, whose docstring
says how each runs and is held to the JAX package's run)."""
import os
import re
import sys

from _torch_cli_runs import REPO, both, last, run_both


def test_char_rnn():
    jax_out, port_out = run_both(
        'examples/rnn/char_rnn.py',
        ['--num-epochs', '1', '--num-hidden', '32', '--num-layers', '1',
         '--num-embed', '16', '--seq-len', '16', '--sample', '20'])
    pattern = r'Epoch\[0\] Train-perplexity=([\d.]+)'
    jax_ppl, port_ppl = last(pattern, jax_out), last(pattern, port_out)
    # five runs each: 20.6-22.1
    assert port_ppl <= 1.15 * jax_ppl, (jax_ppl, port_ppl)
    sample = re.findall(r"sampled: '(.*)'", port_out)
    assert sample and sample[0].startswith('the quick'), port_out[-2000:]


def test_lstm_bucketing():
    jax_out, port_out = run_both(
        'examples/rnn/lstm_bucketing.py',
        ['--num-epochs', '1', '--num-hidden', '32', '--num-layers', '1',
         '--num-embed', '16', '--buckets', '8,16'])
    pattern = r'Epoch\[0\] Train-perplexity=([\d.]+)'
    jax_ppl, port_ppl = last(pattern, jax_out), last(pattern, port_out)
    # five runs each: the JAX package 39.3-49.2, the port 40.5-44.9
    assert port_ppl <= 1.3 * jax_ppl, (jax_ppl, port_ppl)


def test_mnist_gluon():
    jax_out, port_out = run_both('examples/gluon/mnist_gluon.py',
                                 ['--epochs', '1'])
    pattern = r'epoch 0 acc ([\d.]+)'
    jax_acc, port_acc = last(pattern, jax_out), last(pattern, port_out)
    # six seeds each: the JAX package 0.859-0.917, the port 0.825-0.886
    # (at equal weights and order the two give the same accuracy)
    assert port_acc >= jax_acc - 0.15, (jax_acc, port_acc)


def test_dcgan_mnist():
    jax_out, port_out = run_both(
        'examples/gan/dcgan_mnist.py',
        ['--num-epochs', '1', '--num-images', '128', '--batch-size', '32'])
    pattern = r'epoch 0: D acc ([\d.]+)'
    jax_acc, port_acc = last(pattern, jax_out), last(pattern, port_out)
    # seeded in the script: 0.570 and 0.598 in every run
    assert port_acc >= jax_acc - 0.1, (jax_acc, port_acc)
    assert re.search(r'G fool-rate [\d.]+', port_out), port_out[-2000:]


def test_dist_mlp():
    """Two workers and a parameter server from each package's launcher,
    --launcher local."""
    script = os.path.join(REPO, 'examples/distributed/dist_mlp.py')
    jax_out, port_out = both(
        [sys.executable, os.path.join(REPO, 'tools', 'launch.py'), '-n',
         '2', '-s', '1', '--launcher', 'local', sys.executable, script],
        [sys.executable, '-m', 'mxnet_tpu_torch.tools.launch', '-n', '2',
         '-s', '1', '--launcher', 'local', sys.executable, '-m',
         'mxnet_tpu_torch.tools.run_script', '--device', 'cpu', script])
    pattern = r'RANK (\d)/2 final acc ([\d.]+)'
    accs = {name: dict(re.findall(pattern, out))
            for name, out in (('jax', jax_out), ('port', port_out))}
    assert sorted(accs['port']) == sorted(accs['jax']) == ['0', '1'], accs
    for rank in ('0', '1'):
        assert float(accs['port'][rank]) >= \
            float(accs['jax'][rank]) - 0.05, accs
