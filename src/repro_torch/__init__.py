"""PyTorch/CUDA port of the PADPS-FR scheduler (power-aware scheduling of
periodic hardware tasks on accelerator fleets).

Mirrors the JAX package's layout: ``core`` (task model, Alg-1
enumeration, Alg-2 walk and placement backends, Alg-3 placement),
``kernels`` (hand-written CUDA kernels beside their plain torch versions),
``configs`` (the paper's examples) and ``convert`` (building this
package's task and fleet types from any object with the same field names).
Entry points run on the card unless the caller asks for the CPU:
``PADPSFRScheduler(fleet)`` uses ``engine="cuda"``; pass ``engine="torch"``
for the plain sweep on CPU tensors.
"""

__version__ = "0.1.0"
