"""The plain reference of the benchmark: plain NumPy and PyTorch, no kernel,
no batching trick, and nothing imported from the program or the JAX
package (``perfbench.imports`` checks these sources before every run)."""
