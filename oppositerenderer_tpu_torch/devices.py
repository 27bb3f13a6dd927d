"""Compute devices: the default device of the entry points, and the
ComputeDeviceRepository analog.

The counterpart of ``oppositerenderer_tpu/devices.py``. The port renders
on the CUDA card: every entry point that builds tensors (scenes, cameras,
lights, films, atlases, the ``interop`` converters) takes ``device=None``
to mean the card, through :func:`resolve_device`. Without a card that
raises: the CPU, where the kernels' plain versions run, is used only when
the caller asks for it with ``device="cpu"``.

The reference enumerates its CUDA devices with their properties and maps
a user-picked ordinal to a device (``RenderEngine/ComputeDevice.{h,cpp}``,
``ComputeDeviceRepository.cpp:11-23``); :class:`ComputeDeviceRepository`
lists the CUDA cards and the CPU, so the CLI can list them
(``--list-devices``) and pick one (``--device N``). A device's owning
process is its ``torch.distributed`` rank, as the JAX descriptor's is its
``jax.process_index``: every device this process enumerates is its own.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


def process_index() -> int:
    """This process's ``torch.distributed`` rank, or 0 without a process
    group (``jax.process_index``)."""
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``device`` as a ``torch.device``; None is the CUDA card, and raises
    ``RuntimeError`` when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port renders on the card by default; pass "
            'device="cpu" to run the plain PyTorch versions on the CPU')
    return torch.device("cuda")


@dataclass(frozen=True)
class ComputeDevice:
    """One compute device (the reference's ComputeDevice, ComputeDevice.h):
    a CUDA card or the host CPU."""

    ordinal: int                 # position in the repository: the pick index
    name: str                    # the card's name, or "cpu"
    platform: str                # "gpu" or "cpu"
    device: str                  # the torch device, e.g. "cuda:0" or "cpu"
    process_index: int           # owning process: its torch.distributed rank
    compute_capability: tuple[int, int] | None
    multiprocessors: int | None
    memory_total: int | None     # bytes of device memory
    memory_in_use: int | None    # bytes this process has allocated there

    @property
    def is_local(self) -> bool:
        return self.process_index == process_index()

    def summary(self) -> str:
        extra = ""
        if self.platform == "gpu":
            extra = (f"  sm_{self.compute_capability[0]}"
                     f"{self.compute_capability[1]}, "
                     f"{self.multiprocessors} SMs, "
                     f"{(self.memory_in_use or 0) / 2**30:.2f}/"
                     f"{self.memory_total / 2**30:.2f} GiB")
        return (f"[{self.ordinal}] {self.name} ({self.platform}, "
                f"{self.device}) host={self.process_index}{extra}")


@dataclass
class ComputeDeviceRepository:
    """The devices the port can render on (ComputeDeviceRepository.cpp:
    11-23): every CUDA card in CUDA's order, so ordinal i < count is
    ``cuda:i``, then the CPU, where the kernels' plain versions run."""

    devices: list[ComputeDevice] = field(default_factory=list)

    @classmethod
    def enumerate(cls) -> "ComputeDeviceRepository":
        repo = cls()
        rank = process_index()
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        for i in range(n_cards):
            prop = torch.cuda.get_device_properties(i)
            repo.devices.append(ComputeDevice(
                ordinal=i, name=prop.name, platform="gpu", device=f"cuda:{i}",
                process_index=rank,
                compute_capability=(prop.major, prop.minor),
                multiprocessors=prop.multi_processor_count,
                memory_total=prop.total_memory,
                memory_in_use=torch.cuda.memory_allocated(i)))
        repo.devices.append(ComputeDevice(
            ordinal=n_cards, name="cpu", platform="cpu", device="cpu",
            process_index=rank,
            compute_capability=None, multiprocessors=None,
            memory_total=None, memory_in_use=None))
        return repo

    def __len__(self) -> int:
        return len(self.devices)

    def pick(self, ordinal: int) -> torch.device:
        """The torch device of a user-chosen ordinal (the analog of the
        reference's CUDA-to-OptiX ordinal mapping)."""
        if not 0 <= ordinal < len(self.devices):
            raise ValueError(
                f"device ordinal {ordinal} out of range 0..{len(self) - 1}")
        return torch.device(self.devices[ordinal].device)

    def table(self) -> str:
        return "\n".join(d.summary() for d in self.devices)
