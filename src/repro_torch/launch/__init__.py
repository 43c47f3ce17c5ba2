"""The port's entry points (port of ``repro/launch``): ``train``, the
target trainer's demo loop, and ``serve``, the TIDE system behind the
serving CLI.  Both run on the CUDA card unless ``main(..., device="cpu")``
is asked for::

    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tide-tiny

The JAX package's launch tooling (``mesh``, ``sharding``, ``dryrun``:
ROADMAP queue 1 item 9) and its TPU roofline have no port."""
