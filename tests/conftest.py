import os

# Tests run on the CPU backend with 8 virtual devices, so the sharding tests
# run without an accelerator. Tests marked `gpu` need the card and skip here.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
