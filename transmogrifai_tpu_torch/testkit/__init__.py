"""Testkit: contract specs + seeded random typed-data generators, the
port's copy of ``transmogrifai_tpu/testkit/`` (SURVEY §2.15;
testkit/src/main/scala/com/salesforce/op/testkit/)."""
from .random_data import (RandomBinary, RandomData, RandomIntegral,
                          RandomList, RandomMap, RandomReal, RandomSet,
                          RandomText, RandomVector)
from .spec import StageSpecBase

__all__ = ["StageSpecBase", "RandomReal", "RandomIntegral", "RandomBinary",
           "RandomText", "RandomList", "RandomSet", "RandomMap",
           "RandomVector", "RandomData"]
