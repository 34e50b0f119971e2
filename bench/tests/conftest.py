"""The benchmark's CPU tests: run them from the root of a checkout with

    python -m pytest -q bench/tests

(they are not in the repository's tier-1 suite, whose ``testpaths`` is
``tests``).  Tests that need the card are marked ``cuda`` and skip here."""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# each configuration cut to a size the CPU runs in seconds: every width
# small, every other parameter as the cell's files state it
SMALL = {
    "hcl-matmul": {
        "config": {"N": 256, "K": 512, "unit_rows": 8, "units": 32, "blocks": {"bm": 8, "bn": 256, "bk": 512}},
        "traffic": {"check_pool": 64},
    },
    "stablelm-12b": {
        "config": {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4, "num_key_value_heads": 2,
                   "num_hidden_layers": 2, "vocab_size": 512},
        "traffic": {"requests_per_epoch": 8, "prompt_tokens": 16, "check_requests": 64, "check_batch": 16},
    },
}


@pytest.fixture
def small():
    return SMALL


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
