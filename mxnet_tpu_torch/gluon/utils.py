"""Gluon utilities, the counterpart of mxnet_tpu/gluon/utils.py
(reference python/mxnet/gluon/utils.py: split_data, split_and_load,
clip_global_norm)."""
import math

from .. import ndarray as nd


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split an NDArray into `num_slice` slices along batch_axis."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(
            'Too many slices for data with shape %s. Arguments are '
            'num_slice=%d and batch_axis=%d.'
            % (str(data.shape), num_slice, batch_axis))
    if even_split and size % num_slice != 0:
        raise ValueError(
            'data with shape %s cannot be evenly split into %d slices '
            'along axis %d. Use a batch size that is a multiple of '
            'num_slice or set even_split=False.'
            % (str(data.shape), num_slice, batch_axis))
    step = size // num_slice
    if even_split:
        return [nd.slice_axis(data, axis=batch_axis, begin=i * step,
                              end=(i + 1) * step)
                for i in range(num_slice)]
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = size if i == num_slice - 1 else (i + 1) * step
        slices.append(nd.slice_axis(data, axis=batch_axis,
                                    begin=begin, end=end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split data along batch_axis and load each slice to one context."""
    if not isinstance(data, nd.NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Rescale NDArrays so the sum of their 2-norms is <= max_norm."""
    assert len(arrays) > 0
    total_norm = 0.0
    for arr in arrays:
        norm = nd.sum(nd.square(arr)).asscalar()
        total_norm += norm
    total_norm = math.sqrt(total_norm)
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr[:] = (arr * scale).asnumpy()
    return total_norm
