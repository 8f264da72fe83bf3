"""Typed data ingestion of the PyTorch port (the JAX package's
``readers/``; reference readers/src/main/scala/com/salesforce/op/
readers/)."""
from .data_readers import (AggregateDataReader, AvroProductReader,
                           ConditionalDataReader, CSVAutoReader,
                           CSVProductReader, DataReader, DataReaders,
                           ParquetProductReader)
from .joined import (JoinedAggregateReaders, JoinedDataReader,
                     JoinKeys)
from .streaming import StreamingReader, StreamingReaders

__all__ = ["DataReader", "AggregateDataReader", "ConditionalDataReader",
           "CSVProductReader", "CSVAutoReader", "AvroProductReader",
           "ParquetProductReader", "DataReaders", "JoinedDataReader",
           "JoinedAggregateReaders",
           "JoinKeys", "StreamingReader", "StreamingReaders"]
