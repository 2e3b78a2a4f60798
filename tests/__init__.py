"""Test suite of advancedmh_tpu. A package, so that the ``tests.*`` imports
between test modules resolve here and not to another installed ``tests``
package."""
