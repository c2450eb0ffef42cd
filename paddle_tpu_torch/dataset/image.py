"""Image loading and augmentation: resize, crop, flip, CHW, mean.

Parity: reference python/paddle/dataset/image.py and the JAX package's
dataset/image.py: the per-image transforms in numpy on the host
(_bilinear_resize, resize_short, to_chw, center_crop, random_crop,
left_right_flip, simple_transform); simple_transform_batch, which always
runs the native multithreaded routine (csrc/image_aug.cpp through
utils/native.py), with _transform_batch_plain, its plain numpy version,
bit for bit the same; and the decoders (load_image_bytes, load_image,
load_and_transform, batch_images_from_tar), which need PIL and import it
at first use: without PIL they raise ImportError, and nothing else here
needs it.
"""
import os
import tarfile

import numpy as np

__all__ = [
    'load_image_bytes', 'load_image', 'resize_short', 'to_chw', 'center_crop',
    'random_crop', 'left_right_flip', 'simple_transform',
    'simple_transform_batch', 'load_and_transform', 'batch_images_from_tar'
]


def _require_pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            'PIL is required to decode image files; the array transforms '
            '(resize_short, center_crop, simple_transform_batch, ...) work '
            'without it') from e
    return Image


def load_image_bytes(data, is_color=True):
    """Decode an encoded image byte string to an HWC (color) or HW (gray)
    uint8 ndarray."""
    import io
    img = _require_pil().open(io.BytesIO(data))
    img = img.convert('RGB' if is_color else 'L')
    return np.asarray(img)


def load_image(file, is_color=True):
    """Load an image file into an HWC uint8 ndarray (HW when gray)."""
    with open(file, 'rb') as f:
        return load_image_bytes(f.read(), is_color=is_color)


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


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    """load_image + simple_transform in one call (reader mapper helper)."""
    im = load_image(filename, is_color)
    return simple_transform(im, resize_size, crop_size, is_train, is_color,
                            mean)


def simple_transform_batch(images, resize_size, crop_size, is_train,
                           mean=None, seed=0):
    """simple_transform over a whole same-sized [n, h, w, c] uint8 batch:
    [n, c, crop, crop] float32, through the multithreaded C++ routine
    (csrc/image_aug.cpp), always. mean is None, a scalar, one value a
    channel or a [c, crop, crop] image. A train batch's crops and flips
    draw from `seed`, image i from its own stream: the same seed gives the
    same batch."""
    from ..utils import native
    return native.image_transform_batch(images, resize_size, crop_size,
                                        is_train, mean=mean, seed=seed)


_MASK64 = 0xFFFFFFFFFFFFFFFF


class _XorShift64Star(object):
    """The C++ routine's per-image xorshift64* stream (image_aug.cpp Rng)."""

    def __init__(self, seed):
        self.s = seed or 0x9E3779B97F4A7C15

    def next(self):
        s = self.s
        s ^= s >> 12
        s ^= (s << 25) & _MASK64
        s ^= s >> 27
        self.s = s
        return (s * 0x2545F4914F6CDD1D) & _MASK64

    def below(self, n):
        return self.next() % n if n else 0


def _resize_plain(img, oh, ow):
    """image_aug.cpp resize_bilinear_u8 in numpy: the same float32
    positions, weights and products in the same order, rounded half to
    even and clamped to uint8."""
    h, w, c = img.shape
    f32 = np.float32
    sy = f32(h) / f32(oh)
    sx = f32(w) / f32(ow)
    fx = (np.arange(ow, dtype=f32) + f32(0.5)) * sx - f32(0.5)
    x0 = np.clip(np.floor(fx).astype(np.int64), 0, w - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wx = np.clip(fx - x0.astype(f32), f32(0), f32(1))[:, None]
    fy = (np.arange(oh, dtype=f32) + f32(0.5)) * sy - f32(0.5)
    y0 = np.clip(np.floor(fy).astype(np.int64), 0, h - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    wy = np.clip(fy - y0.astype(f32), f32(0), f32(1))[:, None, None]
    src = img.astype(f32)

    def hpass(rows):
        r = src[rows]
        return r[:, x0] * (f32(1) - wx) + r[:, x1] * wx

    v = hpass(y0) * (f32(1) - wy) + hpass(y1) * wy
    return np.clip(np.rint(v), f32(0), f32(255)).astype(np.uint8)


def _transform_batch_plain(images, resize_size, crop_size, is_train,
                           mean=None, seed=0):
    """The plain numpy version of simple_transform_batch, bit for bit the
    C++ routine's output: the same shorter-edge sizes, resize, crop
    offsets and flips (image i's xorshift64* stream seeded from (seed, i)
    as image_aug.cpp seeds it) and mean subtraction in float32."""
    from ..utils.native import transform_mean
    images = np.ascontiguousarray(images, dtype=np.uint8)
    if images.ndim != 4:
        raise ValueError('expected an [n, h, w, c] uint8 batch, got %s'
                         % (images.shape,))
    n, h, w, c = images.shape
    if crop_size <= 0 or resize_size <= 0 or crop_size > resize_size \
            or min(h, w) <= 0:
        raise ValueError('bad transform arguments: h %d, w %d, resize %d, '
                         'crop %d' % (h, w, resize_size, crop_size))
    m = transform_mean(mean, c, crop_size)
    if m is None:
        m = np.zeros((1, 1, 1), np.float32)
    elif m.shape[0] == c * crop_size * crop_size:
        m = m.reshape(c, crop_size, crop_size)
    else:
        m = np.broadcast_to(m.reshape(-1, 1, 1), (c, 1, 1))
    if h > w:
        ow, oh = resize_size, int(round(h * resize_size / float(w)))
    else:
        oh, ow = resize_size, int(round(w * resize_size / float(h)))
    seed = int(seed) & _MASK64
    out = np.empty((n, c, crop_size, crop_size), np.float32)
    for i in range(n):
        im = images[i]
        if (oh, ow) != (h, w):
            im = _resize_plain(im, oh, ow)
        if is_train:
            rng = _XorShift64Star(
                (seed * 0x9E3779B97F4A7C15
                 + 0xBF58476D1CE4E5B9 * (i + 1)) & _MASK64)
            y0 = rng.below(oh - crop_size + 1)
            x0 = rng.below(ow - crop_size + 1)
            flip = rng.below(2) == 0
        else:
            y0, x0, flip = (oh - crop_size) // 2, (ow - crop_size) // 2, False
        crop = im[y0:y0 + crop_size, x0:x0 + crop_size]
        if flip:
            crop = crop[:, ::-1]
        out[i] = crop.transpose(2, 0, 1).astype(np.float32) - m
    return out


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """Pre-split a tar of encoded images into .npz batch files and a meta
    list; returns the meta file's path (reference image.py:
    batch_images_from_tar, which pickles {data, label} blobs). Each batch
    is a compressed npz (data: [N] object array of the encoded bytes,
    label: [N] int64), as the JAX package writes it. Nothing is decoded,
    so no PIL is needed."""
    out_path = "%s/%s_%s" % (os.path.dirname(data_file), dataset_name,
                             'batch')
    meta = out_path + "/batch_file_list.txt"
    if os.path.exists(out_path):
        return meta
    os.makedirs(out_path)

    tf = tarfile.open(data_file)
    names = [n for n in tf.getnames() if n in img2label]
    data, labels, written = [], [], []

    def _flush():
        if not data:
            return
        fname = "%s/batch_%d.npz" % (out_path, len(written))
        np.savez_compressed(fname, data=np.array(data, dtype=object),
                            label=np.array(labels, dtype=np.int64))
        written.append(fname)
        del data[:], labels[:]

    for name in names:
        data.append(tf.extractfile(name).read())
        labels.append(img2label[name])
        if len(data) == num_per_batch:
            _flush()
    _flush()

    with open(meta, 'w') as f:
        f.write('\n'.join(written))
    return meta
