"""Every fault that `chip_faults.py` plants still finds its text in the
kernel sources.

`chip_faults.use_sources` refuses a fault whose text is not in its source
exactly once, but only on the card. This reads the files here, so a
kernel edit that moves a fault's text shows on the CPU.
"""
from __future__ import annotations

import os

import pytest

import chip_faults

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ray_lightning_tpu_torch", "ops", "csrc")


@pytest.mark.parametrize("fault", sorted(chip_faults.FAULTS))
def test_fault_text_occurs_once_in_its_source(fault):
    src, text, planted = chip_faults.FAULTS[fault]
    with open(os.path.join(CSRC, src)) as f:
        code = f.read()
    assert code.count(text) == 1, f"{fault}: {text!r} in {src}"
    assert planted != text and planted not in code


def test_every_source_is_built():
    """A fault's source is one of the built ``.cu`` files or a header
    that one of them includes."""
    built = {}
    for name in chip_faults.SOURCES:
        with open(os.path.join(CSRC, f"{name}.cu")) as f:
            built[f"{name}.cu"] = f.read()
    for src in {src for src, _, _ in chip_faults.FAULTS.values()}:
        assert src in built or any(f'#include "{src}"' in code
                                   for code in built.values()), src
