"""The plain reference the benchmark holds the program against: plain
PyTorch and NumPy, importing nothing of the program nor of the JAX
package, given the same inputs and working out again whatever the
program derives from them."""
