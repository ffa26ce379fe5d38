"""Roofline benchmark (``benchmarks/roofline.py``): reads the port's
dry-run records (:mod:`repro_torch.launch.dryrun`) and emits the three
roofline terms per (arch x shape x mesh) on the H100's figures.  Skips
gracefully until the dry-run has written records."""


def run():
    from .roofline_impl import run_impl
    return run_impl()


if __name__ == "__main__":
    for key, value in run():
        print(f"{key}: {value}")
