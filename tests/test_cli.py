"""CLI smoke tests (reference flag surface, -b 7 and -b 8)."""

import numpy as np

from icde2019_gpu_join.cli import main


def test_cli_device_join(capsys):
    rc = main(["-b", "7", "-a", "HJC", "-R", "4000", "-S", "16000",
               "--seed", "7"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "results" in out and "Total throughput" in out


def test_cli_cpu_oracle(capsys):
    rc = main(["-b", "8", "-R", "4000", "-S", "16000", "--seed", "7"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "results" in out


def test_cli_multipliers(capsys):
    rc = main(["-b", "8", "-R", "1000", "-S", "4000", "-x", "2", "-y", "2",
               "--seed", "7"])
    assert rc == 0
