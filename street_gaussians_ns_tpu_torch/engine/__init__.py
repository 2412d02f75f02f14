"""Runtime around the models: checkpoints carried across from the JAX
package."""
