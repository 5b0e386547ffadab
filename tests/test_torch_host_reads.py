"""The probe of the card's scattered mapped host reads
(``xgnn_tpu_torch/tools/host_reads.py``) off the card: it refuses a CPU
device, and its summaries pick and print the rows it measured."""

import pytest

torch = pytest.importorskip("torch")

from xgnn_tpu_torch.tools import host_reads  # noqa: E402


def test_host_read_rates_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA device"):
        host_reads.host_read_rates(torch, torch.device("cpu"))


def test_host_read_ceiling_and_description():
    rows = [
        {"bytes_per_read": w, "reads_per_warp": n, "reads": 1000, "ms": 1.0,
         "sectors_per_s": rate, "bytes_per_s": rate * 32}
        for w, n, rate in ((32, 4, 2e8), (32, 16, 3e8), (32, 64, 2.5e8),
                           (128, 1, 5e8), (128, 4, 9e8))
    ]
    assert host_reads.ceiling(rows)["reads_per_warp"] == 16
    assert host_reads.ceiling(rows, 128)["sectors_per_s"] == 9e8
    text = host_reads.describe(rows)
    assert text.startswith("32-byte reads")
    assert "16: 300.0M sectors/s 9.60 GB/s" in text
    assert "128-byte reads" in text and "4: 900.0M" in text
