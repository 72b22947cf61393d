"""Schwarz (SAP) smoothers.

SchwarzPreconditioner is also the whole preconditioner of methods 1-3 with
one level or interpolation 0 (the JAX package's smoothers/__init__.py:11-47,
the reference's src/preconditioner.c:25-69): built on the fine
WilsonStencilSoA in the inner precision, it takes dof-major fields
[*B, 12, V] of any complex dtype and returns them in the stencil's.
"""

from .sap import SchwarzPreconditioner

__all__ = ["SchwarzPreconditioner"]
