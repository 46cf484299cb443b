"""The plain reference: plain PyTorch and NumPy, float32 with TF32 off.

It imports nothing of the program (`tts_tpu_torch`), nor `jax` or the JAX
package, and takes nothing the program made: it dequantizes the Q4_0 blocks
the harness made and handed to both sides, and works out again everything
the program derives from them (cross K/V, prepared weights, caches).
"""
