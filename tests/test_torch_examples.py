"""The four PyTorch examples (``examples/*_torch.py``) run at their smoke
size on the CPU: each trains or serves through the port's public surface
and ends with finite losses (for ``serve_batched_torch``, the greedy
tokens' negative log-likelihood); the training examples' losses fall."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("quickstart_torch", "link_prediction_torch",
            "serve_batched_torch", "train_100m_lm_torch")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_at_smoke_size_on_the_cpu(name, capsys):
    out = _load(name).main(["--smoke", "--device", "cpu"])
    printed = capsys.readouterr().out
    if name == "serve_batched_torch":
        assert set(out) == {"qwen2-0.5b", "mamba2-2.7b", "zamba2-7b"}
        assert all(np.isfinite(v) and v >= 0 for v in out.values())
        assert printed.count("nll=") == 3
        return
    losses = out["losses"]
    assert len(losses) >= 2 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "loss=" in printed


def test_example_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        _load("quickstart_torch").main(["--smoke"])
