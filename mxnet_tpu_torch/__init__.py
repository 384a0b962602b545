"""mxnet_tpu_torch: the PyTorch and CUDA port of mxnet_tpu, for NVIDIA
Hopper (H100).

The JAX package `mxnet_tpu` is the reference each part of the port is
tested against; this package imports neither it nor JAX. What runs so
far:

- the imperative core, as in the JAX package: `import mxnet_tpu_torch
  as mx` gives `mx.nd` (NDArray and every tensor op and sampler, over
  torch tensors, `save`/`load` of the JAX package's files), `mx.autograd`
  (on torch autograd), `mx.random`, and `mx.rtc`, whose `Rtc` compiles
  the body of a CUDA kernel with NVRTC for sm_90a and launches it on
  NDArrays (`_nvrtc`). Contexts are `mx.gpu(i)` (the default; `mx.tpu(i)`
  is its alias) and `mx.cpu()`, which the caller asks for;
- the transformer LM (`parallel.transformer`): its forward and its SGD
  train step, on hand-written flash-attention forward and backward
  kernels (`cuda_ops`, `csrc/`);
- the conv with fused BatchNorm statistics (`cuda_conv.conv2d_bn_stats`)
  on a hand-written implicit-GEMM kernel, with its bench
  (`tools.bench_conv_bn`, run on the card as
  `python -m mxnet_tpu_torch.tools.bench_conv_bn`);
- the symbolic path: `mx.sym` (`symbol`: Symbol, shape and dtype
  inference, the JAX package's JSON), `executor` (`simple_bind`, `bind`,
  forward, backward on torch autograd), the layers of `ops/nn.py`, the
  symbol factories of `models` (ResNet, ResNeXt, Inception-v3 and -BN,
  VGG, AlexNet, LeNet, MLP) and `profiler`. A bfloat16 ResNet-50
  trains on the card with `mx.models.resnet.get_symbol(...,
  dtype='bfloat16').simple_bind(mx.gpu(0), data=(256, 3, 224, 224))`,
  its train-mode conv -> BatchNorm pairs on the conv + statistics kernel;
- training through `Module`: `optimizer` (the 13 optimizers, the per-key
  `Updater`, `FusedSGD`), `initializer`, `lr_scheduler`, `metric`, `io`
  (iterators, staging on the card), `recordio`, `model` (checkpoints,
  FeedForward), `callback` and `module` (`Module`, `SequentialModule`,
  `BucketingModule`): `mx.mod.Module(sym).fit(train_iter, ...)` trains
  on `gpu(0)`, `fit(bulk=K)` in K-step dispatches with the metric folded
  on the device (`metric.device_fold`); the executor's stem split and
  ctx_group placement (`group2ctx`);
- Gluon (`mx.gluon`): Parameter, Block, HybridBlock and `hybridize`,
  the layers of `gluon.nn`, the recurrent cells and layers of
  `gluon.rnn`, the losses, Trainer, the data pipeline and the vision
  model zoo;
- recurrent networks: `mx.rnn` (the symbolic cells, `FusedRNNCell` over
  the fused `RNN` op, `BucketSentenceIter`, rnn checkpoints) and
  `init.FusedRNN`; the PTB LSTM language model trains through
  `BucketingModule` on `gpu(0)`;
- images: `mx.image` (decoding, by nvJPEG on the card and cv2 or PIL on
  the host, OpenCV's resize semantics, the augmenters, `ImageIter` and
  `ImageDetIter` with a decode pool whose workers each run on their own
  CUDA stream) and `io.ImageRecordIter`, which feeds `Module.fit` batches
  made on the card; `recordio.pack_img` encodes with nvJPEG on the card;
  the SSD detector (`models.ssd`) over the contrib MultiBox ops;
- serving: `predictor.Predictor` (checkpoints, forward only) and
  `serving.InferenceEngine` (a shape-bucket ladder, a dynamic batcher,
  staging and completion on their own streams, int8 or bf16 weight
  storage, `quantization`), over a Predictor or a bound Module:
  `Predictor.from_checkpoint(prefix, epoch, {'data': shape}).serve(
  max_batch=32)` answers `infer()` calls from many threads on `gpu(0)`;
  `exec_cache` keys the rung programs; `monitor` (`mx.mon.Monitor`) and
  the executor's `reshape`, `partial_forward`, `memory_cost` and
  `debug_str`;
- the serving fleet (`mx.serving_fleet`): `ModelRegistry` pages many
  models' weights under a byte budget (int8 page-out images in pinned
  host memory), `SLO` deadlines drive batching and typed `Overloaded`
  shedding, `ContinuousEngine` batches a per-timestep sequence cell
  continuously in K-tick chunks on the card, and `HttpFront` serves the
  registry over HTTP (`tools/serve_http.py`);
- distributed training (`mx.kvstore`, `mx.kvstore_server`, `mx.dist`,
  `mx.elastic`, `mx.delta`): the local store over several contexts, the
  parameter-server processes, the coordinator's allreduce (star or
  ring) across worker processes started by `tools.launch`, elastic
  checkpoints with delta chains, preemption and the coordinated
  restart; `Module.fit(kvstore='dist_sync', checkpoint=mgr)` trains
  across processes and survives the loss of one;
- the self-healing fleet (`mx.fleet_supervisor`): replica processes
  behind a router with retry on replica death, canary pushes with
  auto-rollback, shadow replay, and `CheckpointPusher`, which pushes a
  training run's commits into the fleet and feeds the verdicts back
  (`tools/serve_fleet.py`);
- the pure-Python remainder: `mx.operator` (CustomOp and the legacy
  NumpyOp / NDArrayOp, whose forward and backward run on the host inside
  the graph), `mx.contrib`, `mx.viz`, `mx.test_utils`,
  `mx.executor_manager`, `mx.log` and `mx.registry`;
- deployment: `Predictor.export_compiled` and `export_artifact`
  (`torch.export` programs; a `.pt2` with the weights baked in runs
  under torch alone), and the C API (`_c_predict_bridge`,
  `_c_api_bridge` and `csrc/capi/`: the MXTPred* predict and the MXT*
  training surfaces, built with the host C++ compiler by
  `_build.c_predict_library`);
- the native runtime (`csrc/native/`, host C++ built by
  `_build.native_library`): `mx.engine`, the dependency-scheduling
  engine, RecordIO's C reader and writer, and
  `io.ImageRecordIter(use_native=True)`, the threaded OpenCV decode
  pipeline.

Importing the package builds and compiles nothing: the kernels are
compiled by `nvcc` at their first launch (`_build`), an `Rtc` body by
NVRTC at its first push, the native runtime by the host C++ compiler at
its first use.
"""
__version__ = '0.1.0'

from . import base
from .base import MXNetError
from . import context
from .context import (Context, cpu, gpu, tpu, current_context, num_gpus,
                      resolve_device)
from . import ops
from . import ndarray
from . import ndarray as nd
from . import random
from . import autograd
from . import rtc
from . import profiler
from . import attribute
from .attribute import AttrScope
from .base import NameManager, Prefix
from . import symbol
from . import symbol as sym
from . import executor
from .executor import Executor
from . import models
from . import initializer
from . import initializer as init
from . import optimizer
from .optimizer import Optimizer
from . import lr_scheduler
from . import metric
from . import io
from .io import DataBatch, DataIter, NDArrayIter, DataDesc
from . import recordio
from . import callback
from . import model
from .model import FeedForward
from . import module
from . import module as mod
from .module import Module
from . import monitor
from . import monitor as mon
from . import exec_cache
from . import quantization
from . import predictor
from . import serving
from . import kvstore
from . import kvstore as kv
from . import kvstore_server
from . import dist
from . import delta
from . import elastic
from . import serving_fleet
from . import fleet_supervisor
from . import gluon
from . import rnn
from . import image
from . import operator
from . import contrib
from . import visualization
from . import visualization as viz
from . import registry
from . import log
from . import executor_manager
from . import test_utils
from . import engine

__all__ = ['AttrScope', 'Context', 'DataBatch', 'DataDesc', 'DataIter',
           'Executor', 'FeedForward', 'MXNetError', 'Module', 'NDArrayIter',
           'NameManager', 'Optimizer', 'Prefix', 'attribute', 'autograd',
           'callback', 'contrib', 'cpu', 'current_context', 'delta', 'dist',
           'elastic', 'engine', 'exec_cache', 'executor', 'executor_manager',
           'fleet_supervisor', 'gluon', 'gpu', 'image', 'init',
           'initializer', 'io', 'kv', 'kvstore', 'kvstore_server', 'log',
           'lr_scheduler', 'metric', 'mod', 'model', 'models', 'module',
           'mon', 'monitor', 'nd', 'ndarray', 'num_gpus', 'operator',
           'optimizer', 'predictor', 'profiler', 'quantization', 'random',
           'recordio', 'registry', 'resolve_device', 'rnn', 'rtc',
           'serving', 'serving_fleet', 'sym', 'symbol', 'test_utils', 'tpu',
           'visualization', 'viz']
