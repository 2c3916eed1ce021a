"""Tests that need the GPU. They skip on a machine without one; run them
on the card with: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/"""
import pytest


@pytest.fixture
def gpu():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev


@pytest.mark.gpu
def test_auto_engine_on_gpu_matches_host_oracle(gpu, tmp_path):
    """methphase --engine auto picks the device engine on the GPU, runs it
    there, and writes the same outputs as the host oracle."""
    from pomfret_tpu.cli import main as cli_main
    from pomfret_tpu.parallel import batch as pb
    from pomfret_tpu.testing import make_multi_block_scenario

    bam, vcf, truth = make_multi_block_scenario(str(tmp_path), n_blocks=4)
    args = ["-c", "50", "--vcf", vcf, bam]
    n0 = pb.DISPATCH_STATS["n_dispatches"]
    p_dev, p_host = str(tmp_path / "dev"), str(tmp_path / "host")
    assert cli_main(["methphase", "-o", p_dev, "--engine", "auto", *args]) == 0
    assert pb.DISPATCH_STATS["n_dispatches"] > n0
    assert cli_main(["methphase", "-o", p_host, "--engine", "host", *args]) == 0
    for ext in (".mp.gtf", ".mp.vcf"):
        assert open(p_dev + ext, "rb").read() == open(p_host + ext, "rb").read()
