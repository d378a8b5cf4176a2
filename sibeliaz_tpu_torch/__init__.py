"""sibeliaz_tpu_torch — the PyTorch/CUDA port of sibeliaz_tpu for one NVIDIA
H100.

It runs the FASTA -> junction graph -> locally collinear blocks -> GFF path
(`python -m sibeliaz_tpu_torch -n`): the graph stage on the card through two
hand-written CUDA kernels (``graph/kernels.py``, sources in ``csrc/``), the
LCB stage in the native C++ engine the JAX package also uses.  It imports
torch and numpy, never jax and never the ``sibeliaz_tpu`` package, so it
runs where JAX is not installed; the host modules it shares with that
package are copies.  ROADMAP.md lists what is not ported yet.
"""

from sibeliaz_tpu_torch.config import Config

__version__ = "0.1.0"

__all__ = ["Config", "__version__"]
