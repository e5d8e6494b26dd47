from elasticsearch_tpu_torch.rest.controller import RestController, RestRequest, RestResponse
from elasticsearch_tpu_torch.rest.handlers import register_handlers
from elasticsearch_tpu_torch.rest.http_server import HttpServer

__all__ = ["RestController", "RestRequest", "RestResponse", "register_handlers", "HttpServer"]
