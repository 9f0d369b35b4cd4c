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


ALL_FAULTS = {**chip_faults.FAULTS, **chip_faults.SMALL_FAULTS}


@pytest.mark.parametrize("fault", sorted(ALL_FAULTS))
def test_fault_text_occurs_once_in_its_source(fault):
    src, text, planted = ALL_FAULTS[fault]
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
    for src in {src for src, _, _ in ALL_FAULTS.values()}:
        assert src in built or any(f'#include "{src}"' in code
                                   for code in built.values()), src


def test_bert_faults_are_planted_in_the_sources_bert_builds():
    """``--bert`` builds only the flash sources: each of its faults is
    planted in one of them."""
    faults = [chip_faults.FAULTS[f] for f in chip_faults.BERT_FAULTS]
    faults += list(chip_faults.SMALL_FAULTS.values())
    for src, _, _ in faults:
        assert src[:-len(".cu")] in chip_faults.BERT_SOURCES, src


def test_axes_faults_are_the_flash_faults_in_the_sources_it_builds():
    """``--axes`` plants every flash fault and builds only the flash
    sources, in which each of its faults lies."""
    assert set(chip_faults.AXES_FAULTS) == {
        f for f, (src, _, _) in chip_faults.FAULTS.items()
        if src.startswith("flash")}
    for fault in chip_faults.AXES_FAULTS:
        src = chip_faults.FAULTS[fault][0]
        assert src[:-len(".cu")] in chip_faults.BERT_SOURCES, src
