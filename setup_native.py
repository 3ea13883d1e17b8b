"""Build the native C extension: python setup_native.py build_ext --inplace."""

from setuptools import Extension, setup

setup(
    name="glomargridding-jax-native",
    ext_modules=[
        Extension(
            "glomargridding_jax.native._gridbin",
            sources=["glomargridding_jax/native/gridbin.c"],
            extra_compile_args=["-O3"],
        )
    ],
)
