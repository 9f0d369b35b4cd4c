"""Every variant that `chip_variants.py` builds still finds its text in the
kernel sources.

`chip_variants.patched` refuses a variant whose text is not in its source
exactly once, but only on the card. This reads the files here, so a kernel
edit that moves a variant's text shows on the CPU.
"""
from __future__ import annotations

import pytest

import chip_variants

CASES = [("decode", name, v[0]) for name, v in chip_variants.DECODE.items()] \
    + [("rms", name, p) for name, p in chip_variants.RMS.items()]


@pytest.mark.parametrize("kind,name,patches", CASES,
                         ids=[f"{k} {n}" for k, n, _ in CASES])
def test_variant_text_occurs_once_in_its_source(kind, name, patches):
    code = chip_variants.patched(kind, name, patches)
    for old, new in patches:
        assert new in code


def test_probe_names_the_kernel():
    """The cluster probe appended to each decode copy calls the kernel by
    the name the source gives it."""
    code = chip_variants.patched("decode", "as built", [])
    assert "decode_cluster(" in code and "struct Decode" in code
    assert "decode_cluster<128>" in chip_variants.PROBE
