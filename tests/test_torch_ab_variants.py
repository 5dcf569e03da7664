"""The attribution builds of ``scripts/torch_raster_ab.py`` are exact edits
of the tree's kernel sources: each marker must occur once in
``mobgs_tpu_torch/csrc/raster_{fwd,bwd}.cu``, so a later change to a source
cannot silently turn an attribution build into a copy of the tree. Needs no
compiler and no card."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _ab():
    spec = importlib.util.spec_from_file_location(
        "torch_raster_ab", ROOT / "scripts" / "torch_raster_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


AB = _ab()
CASES = [(k, v) for k, names in AB.VARIANTS.items() for v in names]


def _tree(kernel):
    return (ROOT / "mobgs_tpu_torch" / "csrc" / f"raster_{kernel}.cu").read_text()


@pytest.mark.parametrize("kernel,label", CASES, ids=[f"{k}-{v}" for k, v in CASES])
def test_variant_is_an_edit_of_the_tree(kernel, label):
    tree = _tree(kernel)
    built = AB.variants(kernel, tree)
    assert set(built) == set(AB.VARIANTS[kernel])
    text = built[label]
    assert text != tree
    # an edit, not a rewrite: the entry point the A/B script binds survives
    assert f'extern "C" int raster_{kernel}(' in text


@pytest.mark.parametrize("kernel,marker", [
    ("fwd", AB.COLOUR_CALL), ("fwd", AB.SLOTS_LINE),
    ("fwd", AB.WALK_START), ("fwd", AB.WALK_END), ("fwd", AB.PPT_LINE),
    ("fwd", AB.EXACT_PICKS[0]), ("fwd", AB.EXACT_PICKS[1]),
    ("fwd", AB.TILE_LINE), ("fwd", AB.WRITE_START), ("fwd", AB.WRITE_END),
    ("bwd", AB.PHASE_B_START), ("bwd", AB.PHASE_B_END)])
def test_markers_occur_once_and_are_required(kernel, marker):
    tree = _tree(kernel)
    assert tree.count(marker) == 1
    with pytest.raises(RuntimeError, match="variant"):
        AB.variants(kernel, tree.replace(marker, ""))
    with pytest.raises(RuntimeError, match="variant"):
        AB.variants(kernel, tree.replace(marker, marker + marker))


def test_backward_atomics_are_counted():
    tree = _tree("bwd")
    assert len(AB.ATOMIC.findall(tree)) == AB.N_ATOMICS
    one = AB.ATOMIC.sub("atomicAdd_removed();", tree, count=1)
    with pytest.raises(RuntimeError, match="no_atomics"):
        AB.variants("bwd", one)
