from setuptools import find_packages, setup

setup(
    name="pointtinybenchmark_tpu",
    version="0.1.0",
    description=("TPU-native (JAX/XLA/Pallas) tiny-object detection and "
                 "point-supervised localization framework with the "
                 "capabilities of ucas-vg/PointTinyBenchmark"),
    packages=find_packages(include=["pointtinybenchmark_tpu*",
                                    "pointtinybenchmark_tpu_torch*"]),
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy", "scipy"],
)
