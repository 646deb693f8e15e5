"""The serving checks of ``test_torch_serve.py`` (prefill and decode
logits and caches, greedy tokens, temperature 1.5 with the reference's
Gumbel draws replayed) for the archs beyond GQA + dense MLP: the SSM
(mamba2), MoE (granite-moe), MLA + MoE with shared experts (deepseek), the
hybrid (jamba) and the encoder-decoder (whisper), at REDUCED in f32 against
the JAX package."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS  # noqa: E402
from test_torch_serve import (DENSE, check_greedy,  # noqa: E402
                              check_prefill_and_decode, check_sampled)

MIXERS = ("mamba2-2.7b", "granite-moe-1b-a400m", "deepseek-v2-lite-16b",
          "jamba-1.5-large-398b", "whisper-base")


def test_the_two_files_cover_every_arch():
    assert sorted(DENSE + MIXERS) == sorted(ARCH_IDS)


@pytest.mark.parametrize("arch", MIXERS)
def test_prefill_and_decode_match_reference(arch):
    check_prefill_and_decode(arch)


@pytest.mark.parametrize("arch", MIXERS)
def test_greedy_generate_matches_reference(arch):
    check_greedy(arch)


@pytest.mark.parametrize("arch", MIXERS)
def test_sampled_generate_replays_reference_draws(arch, monkeypatch):
    check_sampled(arch, monkeypatch)
