"""``python -m cubed_tpu_torch.chaos`` — composed-failure campaign CLI.

Thin entry point over :mod:`cubed_tpu_torch.runtime.campaign`; see that module
for the schedule format and docs/reliability.md for the repro/shrink
workflow.
"""

from .runtime.campaign import main

if __name__ == "__main__":
    raise SystemExit(main())
