"""How paddle_tpu_torch/ops/_cuda.py names a kernel library build: by a
hash of everything the build reads, so a stale library is never loaded.
An edited source, an edited header beside it (every source includes
csrc/port_cuda.cuh, the attention sources csrc/tf32_mma.cuh too) or other
nvcc flags give another library path, and so a new build. No nvcc needed:
the path is computed from the files, here on a copy of csrc/."""
import os
import re
import shutil

import pytest

from paddle_tpu_torch.ops import _cuda

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    _cuda.__file__))), 'csrc')
SOURCES = sorted(f for f in os.listdir(CSRC) if f.endswith('.cu'))


@pytest.fixture
def copy(tmp_path):
    """A copy of csrc/ under tmp_path; returns (root, csrc copy)."""
    shutil.copytree(CSRC, str(tmp_path / 'csrc'))
    return str(tmp_path), str(tmp_path / 'csrc')


def _edit(path, extra='\n// edited\n'):
    with open(path, 'a') as f:
        f.write(extra)


@pytest.mark.parametrize('source', SOURCES)
def test_an_unchanged_copy_names_the_package_build(copy, source):
    root, _ = copy
    lib = _cuda._Library('csrc/' + source, root=root)
    assert lib.library_path() == \
        _cuda._Library('csrc/' + source).library_path()


@pytest.mark.parametrize('header', ['port_cuda.cuh', 'tf32_mma.cuh'])
@pytest.mark.parametrize('source', ['flash_attention_fwd.cu',
                                    'flash_attention_bwd.cu'])
def test_an_edited_header_names_a_new_build(copy, source, header):
    root, csrc = copy
    lib = _cuda._Library('csrc/' + source, root=root)
    before = lib.library_path()
    with open(os.path.join(csrc, header)) as f:
        text = f.read()
    _edit(os.path.join(csrc, header))
    assert lib.library_path() != before
    with open(os.path.join(csrc, header), 'w') as f:
        f.write(text)
    assert lib.library_path() == before    # named by content, not by time


def test_an_edited_source_or_other_flags_name_a_new_build(copy,
                                                          monkeypatch):
    root, csrc = copy
    lib = _cuda._Library('csrc/flash_attention_fwd.cu', root=root)
    before = lib.library_path()
    monkeypatch.setattr(_cuda, 'NVCC_FLAGS', _cuda.NVCC_FLAGS + ('-lineinfo',))
    flagged = lib.library_path()
    assert flagged != before
    monkeypatch.undo()
    assert lib.library_path() == before
    _edit(os.path.join(csrc, 'flash_attention_fwd.cu'))
    assert lib.library_path() not in (before, flagged)
    # the path keeps the source's name, so builds of two sources never clash
    assert os.path.basename(lib.library_path()).startswith(
        'libflash_attention_fwd-')


def test_files_that_are_no_header_leave_the_build_alone(copy):
    root, csrc = copy
    lib = _cuda._Library('csrc/flash_attention_fwd.cu', root=root)
    before = lib.library_path()
    _edit(os.path.join(csrc, 'NOTES.txt'), 'not read by nvcc\n')
    assert lib.library_path() == before


@pytest.mark.parametrize('source', SOURCES)
def test_every_included_file_is_a_header_the_hash_covers(source):
    """The hash reads the *.cuh files of csrc/: every file a source
    includes with quotes must be one of them."""
    with open(os.path.join(CSRC, source)) as f:
        included = re.findall(r'^#include\s+"([^"]+)"', f.read(), re.M)
    assert 'port_cuda.cuh' in included
    for name in included:
        assert name.endswith('.cuh') and '/' not in name
        assert os.path.exists(os.path.join(CSRC, name))
