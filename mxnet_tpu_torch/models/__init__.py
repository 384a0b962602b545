"""Model zoo: symbol factories, the counterpart of mxnet_tpu/models/.

Reference: example/image-classification/symbols/*.py. The port has the
JAX package's factories but SSD: lenet, mlp, resnet, alexnet, vgg,
inception-bn, inception-v3 and resnext, each building the JAX package's
graph (the same JSON) with the port's symbol API. SSD needs the contrib
MultiBox ops, which the port's registry does not have yet:
`get_symbol('ssd')` raises.
"""
from ..base import unported
from . import (lenet, mlp, resnet, alexnet, vgg, inception_bn,
               inception_v3, resnext)


def _ssd(**kwargs):
    raise unported("get_symbol('ssd') (models/ssd.py, the contrib "
                   "MultiBox ops)", '4c')


_FACTORY = {
    'lenet': lenet.get_symbol,
    'mlp': mlp.get_symbol,
    'resnet': resnet.get_symbol,
    'alexnet': alexnet.get_symbol,
    'vgg': vgg.get_symbol,
    'inception-bn': inception_bn.get_symbol,
    'inception_bn': inception_bn.get_symbol,
    'inception-v3': inception_v3.get_symbol,
    'inception_v3': inception_v3.get_symbol,
    'resnext': resnext.get_symbol,
    'ssd': _ssd,
}


def get_symbol(network, **kwargs):
    """Factory dispatch (the role of example/image-classification
    train scripts' `import symbols.<net>`)."""
    if network.startswith('resnet'):
        if network != 'resnet':
            kwargs.setdefault('num_layers', int(network[len('resnet'):]))
        return resnet.get_symbol(**kwargs)
    return _FACTORY[network](**kwargs)
