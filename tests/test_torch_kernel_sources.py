"""Which CUDA source runs each flash kernel, and the sources' build key.

``kernels.flash_attention._library`` picks the source by kernel, head
dim and dtype.  ``_build.library_path`` names a library's build by a
hash of its source, the ``csrc/`` headers it includes and the flags.
The Hopper flash sources share ``flash_hopper.cuh``: an edit there has
to rebuild both, and must not rebuild a source that does not include
it.  The copies live in a temporary directory; nothing is compiled.
"""

import shutil

import pytest
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa

HEADER = "flash_hopper.cuh"


@pytest.fixture()
def csrc(tmp_path):
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp_path / f.name)
    return tmp_path


def _edit(path):
    path.write_text(path.read_text() + "\n// edited\n")


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_d256"])
def test_header_edit_changes_key(csrc, name):
    assert csrc / HEADER in _build.included_headers(csrc / f"{name}.cu")
    before = _build.library_path(name, csrc)
    assert _build.library_path(name, csrc) == before
    _edit(csrc / HEADER)
    assert _build.library_path(name, csrc) != before


@pytest.mark.parametrize("name", ["flash_attention_mma", "paged_attention",
                                  "rms_norm"])
def test_header_edit_keeps_other_keys(csrc, name):
    assert _build.included_headers(csrc / f"{name}.cu") == []
    before = _build.library_path(name, csrc)
    _edit(csrc / HEADER)
    assert _build.library_path(name, csrc) == before
    _edit(csrc / f"{name}.cu")
    assert _build.library_path(name, csrc) != before


def test_nested_header_counts(csrc):
    """A header included by the shared header is part of the key too."""
    (csrc / "inner.cuh").write_text("#pragma once\n")
    shared = csrc / HEADER
    shared.write_text('#include "inner.cuh"\n' + shared.read_text())
    before = _build.library_path("flash_attention", csrc)
    _edit(csrc / "inner.cuh")
    assert _build.library_path("flash_attention", csrc) != before


def test_checkout_key_names_its_source():
    path = _build.library_path("flash_attention_d256")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("flash_attention_d256-")


@pytest.mark.parametrize("D, dtype, kernel, source", [
    (64, torch.bfloat16, "fwd", "flash_attention"),
    (96, torch.float16, "dq", "flash_attention"),
    (128, torch.bfloat16, "dkv", "flash_attention"),
    (256, torch.bfloat16, "fwd", "flash_attention_d256"),
    (256, torch.float16, "dkv", "flash_attention_d256"),
    (256, torch.bfloat16, "dq", "flash_attention_d256"),
    (256, torch.float16, "dq", "flash_attention_d256"),
    (256, torch.float32, "dq", "flash_attention_mma"),
    (256, torch.float32, "fwd", "flash_attention_mma"),
    (240, torch.bfloat16, "fwd", "flash_attention_mma"),
    (64, torch.float32, "dkv", "flash_attention_mma"),
])
def test_flash_library_routing(D, dtype, kernel, source):
    assert fa._library(D, dtype, kernel) == source
    assert (_build.CSRC / f"{source}.cu").is_file()
