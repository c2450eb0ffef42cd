"""Version metadata (parity: the JAX package's version.py; the reference
generates python/paddle/version.py at build time with full_version, major,
minor, patch, rc, istaged, commit and with_mkl). Static here: no build
stamps it."""
major = 0
minor = 14
patch = '0'
rc = 0
version = '0.14.0'
full_version = '0.14.0+cuda.r1'
commit = 'cuda-port'
istaged = True
with_mkl = 'OFF'  # the port runs on CUDA; no MKL-DNN path exists


def show():
    if istaged:
        print('full_version:', full_version)
        print('major:', major)
        print('minor:', minor)
        print('patch:', patch)
        print('rc:', rc)
    else:
        print('commit:', commit)


def mkl():
    return with_mkl
