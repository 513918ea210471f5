"""Quick-gate claims check: every speed figure quoted in README/PARITY/
design.md names the card and power limit it was measured on
(tools/check_claims.py), so no number outlives its machine."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_doc_claims_match_artifacts():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "check_claims.py")],
        capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 0, (
        f"unlabelled speed figures:\n{proc.stdout}{proc.stderr}")
    assert "claims checked" in proc.stdout
