"""Checks that need an NVIDIA GPU (the words scan and the device
scatter-add, compiled for the card). They skip on the CPU; chip_smoke.py's phase 7 calls the
same check functions on the card."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


@pytest.mark.gpu
def test_words_scan_on_device(gpu_device):
    cs.check_words_scan_on_device()


@pytest.mark.gpu
def test_bincount_on_device(gpu_device):
    cs.check_bincount_on_device()
