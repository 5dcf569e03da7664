"""The kernel libraries' cache key: ``build/kernels/lib<name>_<hash>.so``
must change with every header beside the kernels, so an added or edited
header is never served by a stale library. Needs no compiler."""

import shutil

import pytest

from mobgs_tpu_torch.ops import cuda_raster


@pytest.mark.parametrize("change", ("added", "edited", "renamed"))
def test_library_path_follows_every_header(change, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_raster.CSRC, csrc)
    monkeypatch.setattr(cuda_raster, "CSRC", csrc)
    before = {n: cuda_raster._library_path(n) for n in cuda_raster.KERNELS}
    header = csrc / "raster_common.cuh"
    if change == "added":
        (csrc / "raster_extra.cuh").write_text("#pragma once\n")
    elif change == "edited":
        header.write_text(header.read_text() + "// edited\n")
    else:
        header.rename(csrc / "raster_shared.cuh")
    after = {n: cuda_raster._library_path(n) for n in cuda_raster.KERNELS}
    for name in cuda_raster.KERNELS:
        assert after[name] != before[name], name
        assert after[name].parent == before[name].parent
        assert after[name].name.startswith(f"lib{name}_")


def test_library_path_is_stable_and_per_kernel(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_raster.CSRC, csrc)
    monkeypatch.setattr(cuda_raster, "CSRC", csrc)
    first = [cuda_raster._library_path(n) for n in cuda_raster.KERNELS]
    assert first == [cuda_raster._library_path(n) for n in cuda_raster.KERNELS]
    assert len(set(first)) == len(first)
    # an edit to one kernel's source moves only that kernel's library
    src = csrc / "raster_bwd.cu"
    src.write_text(src.read_text() + "// edited\n")
    assert cuda_raster._library_path("raster_fwd") == first[0]
    assert cuda_raster._library_path("raster_bwd") != first[1]
