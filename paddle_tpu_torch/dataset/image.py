"""Image augmentation: resize, crop, flip, CHW, mean subtraction.

Parity: reference python/paddle/dataset/image.py and the JAX package's
dataset/image.py:51-146 (_bilinear_resize, resize_short, to_chw,
center_crop, random_crop, left_right_flip, simple_transform), in numpy on
the host. The file and tar loaders (PIL) are not carried: the port's
datasets are synthetic.
"""
import numpy as np

__all__ = ['resize_short', 'to_chw', 'center_crop', 'random_crop',
           'left_right_flip', 'simple_transform']


def _bilinear_resize(im, out_h, out_w):
    """Bilinear resize of an HW[C] array (half-pixel centers, as common
    image libraries give it)."""
    h, w = im.shape[:2]
    if (h, w) == (out_h, out_w):
        return im
    squeeze = im.ndim == 2
    arr = im[:, :, None].astype(np.float32) if squeeze \
        else im.astype(np.float32)
    ys = (np.arange(out_h, dtype=np.float32) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w, dtype=np.float32) + 0.5) * (w / out_w) - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    top = arr[y0][:, x0] * (1 - wx) + arr[y0][:, x1] * wx
    bot = arr[y1][:, x0] * (1 - wx) + arr[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(im.dtype, np.integer):
        out = np.clip(np.rint(out), np.iinfo(im.dtype).min,
                      np.iinfo(im.dtype).max)
    out = out.astype(im.dtype)
    return out[:, :, 0] if squeeze else out


def resize_short(im, size):
    """Resize so the shorter edge equals ``size``, preserving aspect."""
    h, w = im.shape[:2]
    if h > w:
        out_h, out_w = int(round(h * size / float(w))), size
    else:
        out_h, out_w = size, int(round(w * size / float(h)))
    return _bilinear_resize(im, out_h, out_w)


def to_chw(im, order=(2, 0, 1)):
    """Transpose an HWC image to CHW (or any given axis order)."""
    assert len(im.shape) == len(order)
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    """Crop a ``size x size`` window from the image center."""
    h, w = im.shape[:2]
    h0 = (h - size) // 2
    w0 = (w - size) // 2
    if len(im.shape) == 3 and is_color:
        return im[h0:h0 + size, w0:w0 + size, :]
    return im[h0:h0 + size, w0:w0 + size]


def random_crop(im, size, is_color=True):
    """Crop a ``size x size`` window at a uniformly random offset (numpy's
    global generator)."""
    h, w = im.shape[:2]
    h0 = np.random.randint(0, h - size + 1)
    w0 = np.random.randint(0, w - size + 1)
    if len(im.shape) == 3 and is_color:
        return im[h0:h0 + size, w0:w0 + size, :]
    return im[h0:h0 + size, w0:w0 + size]


def left_right_flip(im, is_color=True):
    """Mirror the image horizontally."""
    if len(im.shape) == 3 and is_color:
        return im[:, ::-1, :]
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    """The standard train/eval augmentation: shorter-edge resize, then
    random crop + 50% flip (train) or center crop (eval), CHW float32,
    optional per-channel or elementwise mean subtraction."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color=is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color=is_color)
    if len(im.shape) == 3:
        im = to_chw(im)
    im = im.astype('float32')
    if mean is not None:
        mean = np.array(mean, dtype=np.float32)
        if mean.ndim == 1 and is_color:
            mean = mean[:, np.newaxis, np.newaxis]
        im -= mean
    return im
