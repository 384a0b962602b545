"""Model zoo: symbol factories, the counterpart of mxnet_tpu/models/.

Reference: example/image-classification/symbols/*.py and example/ssd.
The port has every factory of the JAX package: lenet, mlp, resnet,
alexnet, vgg, inception-bn, inception-v3, resnext and ssd (the VGG16
SSD's training symbol; `ssd.get_symbol` gives its detection symbol),
each building the JAX package's graph (the same JSON) with the port's
symbol API.
"""
from . import (lenet, mlp, resnet, alexnet, vgg, inception_bn, ssd,
               inception_v3, resnext)


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
    'ssd': ssd.get_symbol_train,
}


def get_symbol(network, **kwargs):
    """Factory dispatch (the role of example/image-classification
    train scripts' `import symbols.<net>`)."""
    if network.startswith('resnet'):
        if network != 'resnet':
            kwargs.setdefault('num_layers', int(network[len('resnet'):]))
        return resnet.get_symbol(**kwargs)
    return _FACTORY[network](**kwargs)
