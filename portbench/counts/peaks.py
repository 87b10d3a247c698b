"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W): 989.4 TFLOP/s in bf16 and 3.35 TB/s of HBM3.  Keyed on a fragment
of ``torch.cuda.get_device_name()``; a card not in the table raises, so no
share is ever reported against another part's peak."""

from __future__ import annotations

BF16_FLOPS = 989.4e12
HBM_BYTES_S = 3.35e12

_CARDS = (("H100 80GB HBM3", (BF16_FLOPS, HBM_BYTES_S)),
          ("H100 SXM", (BF16_FLOPS, HBM_BYTES_S)))


def card_peaks(device_name: str) -> tuple[float, float]:
    """(bf16 FLOP/s, HBM bytes/s) of the card named ``device_name``."""
    for tag, peaks in _CARDS:
        if tag in device_name:
            return peaks
    raise ValueError(f"no published peak for {device_name!r}: the table lists "
                     f"{[tag for tag, _ in _CARDS]}")
