"""The examples with no quick mode, unedited, on the port on the CPU.

Each runs from its command line at one small setting of its own (one
epoch, a few batches, synthetic data or the example's own small data)
twice, at the same time: on the JAX package (`python script.py ...`) and
on the port through the runner (`python -m
mxnet_tpu_torch.tools.run_script --device cpu script.py ...`). Both must
finish, and the port's final metric may be worse than the JAX run's by
no more than the margin stated beside it: neither run seeds its weights,
so a metric after one short epoch spreads over runs, and each margin
covers the spread of five or six runs of each package (measured on the
CPU at these settings).
The logging of both runs is set to INFO, where Module.fit reports its
epoch metrics (tests/_torch_cli_runs.py).

The image-classification scripts run with --tpus absent, where their
common/fit.py takes cpu(0) after asking `jax.devices()`; on the card
they take --tpus 0 (chip_smoke.py phase 39). The two examples that
import jax in their own code cannot run where JAX is not installed, as
on the card's host: their tests pin that failure.
"""
import json

from _torch_cli_runs import last, run_both, run_without_jax


def test_train_mnist():
    jax_out, port_out = run_both(
        'examples/image_classification/train_mnist.py',
        ['--network', 'mlp', '--num-epochs', '1', '--num-examples', '512',
         '--batch-size', '64', '--disp-batches', '4'])
    pattern = r'Epoch\[0\] Validation-accuracy=([\d.]+)'
    jax_acc, port_acc = last(pattern, jax_out), last(pattern, port_out)
    assert port_acc >= jax_acc - 0.05, (jax_acc, port_acc)
    assert 'Speed:' in port_out


def test_train_imagenet():
    """The BASELINE script on synthetic data at a CIFAR-sized ResNet-20
    (float32: bfloat16 on the CPU is no part of either package's
    tests); 4 steps from scratch, so the accuracy spreads."""
    jax_out, port_out = run_both(
        'examples/image_classification/train_imagenet.py',
        ['--network', 'resnet', '--num-layers', '20', '--image-shape',
         '3,28,28', '--num-classes', '10', '--num-examples', '128',
         '--batch-size', '32', '--num-epochs', '1', '--dtype', 'float32',
         '--disp-batches', '2'])
    pattern = r'Epoch\[0\] Validation-top_k_accuracy_5=([\d.]+)'
    jax_acc, port_acc = last(pattern, jax_out), last(pattern, port_out)
    # five runs each: the JAX package 0.859-0.930, the port 0.914-1.0
    assert port_acc >= jax_acc - 0.2, (jax_acc, port_acc)


def test_train_ssd():
    """SSD300 (the side its anchors need) at batch 1 for the 16 batches
    of the example's synthetic iterator; the metric is its loc loss."""
    jax_out, port_out = run_both(
        'examples/ssd/train_ssd.py',
        ['--batch-size', '1', '--num-epochs', '1'], timeout=900)
    pattern = r'Epoch\[0\] Train-loss=([\d.e-]+)'
    jax_loss, port_loss = last(pattern, jax_out), last(pattern, port_out)
    # four runs each: 0.001252 and 0.001351 in every run
    assert port_loss <= 1.5 * jax_loss, (jax_loss, port_loss)


def test_lstm_model_parallel_needs_jax():
    """It asks jax.devices() for its ctx_group contexts: without JAX it
    stops at `import jax`."""
    proc = run_without_jax('examples/model_parallel/lstm_model_parallel.py')
    assert proc.returncode != 0
    assert 'ModuleNotFoundError: import of jax halted' in proc.stderr, \
        proc.stderr[-3000:]
    assert 'run_script: ' not in proc.stderr


def test_benchmark_needs_jax():
    """It asks jax.devices() for its context in each measurement, whose
    failure it records as the row's error and goes on: without JAX every
    row is that error and it measures nothing."""
    proc = run_without_jax('examples/image_classification/benchmark.py',
                           ['--batch-sizes', '2,4'])
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith('{')]
    assert len(rows) == 2, proc.stdout
    for row in rows:
        assert 'images_per_sec' not in row, row
        assert 'import of jax halted' in row['error'], row
    assert 'best:' not in proc.stdout
