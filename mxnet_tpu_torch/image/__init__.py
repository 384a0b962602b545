"""mx.image: image decoding, augmentation and the image iterators, the
counterpart of mxnet_tpu/image/ (reference python/mxnet/image/). JPEG
decodes on the card with nvJPEG (`_nvjpeg`), on the host with cv2 or
PIL."""
from .image import (imdecode, imread, imresize, copyMakeBorder, scale_down,
                    resize_short, fixed_crop, random_crop, center_crop,
                    random_size_crop, color_normalize,
                    Augmenter, ResizeAug, ForceResizeAug, RandomCropAug,
                    RandomSizedCropAug, CenterCropAug, RandomOrderAug,
                    BrightnessJitterAug, ContrastJitterAug,
                    SaturationJitterAug, ColorJitterAug, LightingAug,
                    ColorNormalizeAug, HorizontalFlipAug, CastAug,
                    CreateAugmenter, ImageIter, decode_workers_from_env)
from .detection import (DetAugmenter, DetBorrowAug, DetRandomSelectAug,
                        DetHorizontalFlipAug, DetRandomCropAug,
                        DetRandomPadAug, CreateDetAugmenter, ImageDetIter)
