"""``bench.py``'s device bookkeeping (CPU-side: no timing here)."""

import pytest

import bench


def test_peaks_known_card():
    p = bench.peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12 and p["bf16_flops"] == 989e12
    assert "source" in p


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H200", "NVIDIA A100-SXM4-80GB"])
def test_peaks_unknown_card_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        bench.peaks(kind)


def test_main_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code != 0
    assert "no GPU" in capsys.readouterr().err
