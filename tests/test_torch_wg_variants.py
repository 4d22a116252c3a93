"""scripts/wg_variants.py builds each rejected design of K6's and K9's
wgmma bodies as edits of the committed CUDA sources: every edit must still
match the committed text exactly once (the script refuses otherwise), so
the record of those designs builds against the tree it ships with."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import wg_variants  # noqa: E402

CSRC = os.path.join(ROOT, "smoothquant_tpu_torch", "kernels", "csrc")


@pytest.mark.parametrize("name", sorted(wg_variants.VARIANTS))
def test_variant_edits_apply_to_committed_sources(name):
    src, edits = wg_variants.VARIANTS[name]
    with open(os.path.join(CSRC, src)) as f:
        text = f.read()
    out = wg_variants.apply_edits(text, edits)
    assert out != text
    # the variant still defines the kernel the wrapper launches
    kernel = "wg_gmm_kernel" if src == wg_variants.K6_SRC else "dual_path_wg_kernel"
    assert f"{kernel}(" in out


def test_a_stale_edit_is_refused():
    with pytest.raises(ValueError, match="exactly once"):
        wg_variants.apply_edits("int x;", [("int y;", "int z;")])
