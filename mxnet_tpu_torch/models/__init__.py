"""Model zoo: symbol factories, the counterpart of mxnet_tpu/models/.

Reference: example/image-classification/symbols/*.py. The port has the
ResNet factory so far; the JAX package's other networks (lenet, mlp,
alexnet, vgg, inception, resnext, ssd) come with the ops they use.
"""
from . import resnet

_FACTORY = {
    'resnet': resnet.get_symbol,
}


def get_symbol(network, **kwargs):
    """Factory dispatch (the role of example/image-classification
    train scripts' `import symbols.<net>`)."""
    if network.startswith('resnet'):
        if network != 'resnet':
            kwargs.setdefault('num_layers', int(network[len('resnet'):]))
        return resnet.get_symbol(**kwargs)
    return _FACTORY[network](**kwargs)
