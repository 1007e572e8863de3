"""``python -m cubed_tpu_torch.audit`` — post-hoc invariant auditor CLI.

Thin entry point over :mod:`cubed_tpu_torch.runtime.audit`; see that module for
the invariant catalogue.
"""

from .runtime.audit import main

if __name__ == "__main__":
    raise SystemExit(main())
