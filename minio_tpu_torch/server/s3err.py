"""S3 API error codes + XML error responses.

Mirrors the reference's APIError table (cmd/api-errors.go) for the codes the
framework serves; same XML wire shape S3 clients parse.
"""

from __future__ import annotations

from dataclasses import dataclass
from xml.sax.saxutils import escape


@dataclass(frozen=True)
class APIError(Exception):
    code: str
    description: str
    http_status: int

    def to_xml(self, resource: str = "", request_id: str = "") -> bytes:
        return (
            '<?xml version="1.0" encoding="UTF-8"?>'
            f"<Error><Code>{escape(self.code)}</Code>"
            f"<Message>{escape(self.description)}</Message>"
            f"<Resource>{escape(resource)}</Resource>"
            f"<RequestId>{escape(request_id)}</RequestId>"
            "</Error>"
        ).encode()


ERR_NONE = None

AccessDenied = APIError("AccessDenied", "Access Denied.", 403)
BadDigest = APIError("BadDigest", "The Content-Md5 you specified did not match what we received.", 400)
EntityTooLarge = APIError("EntityTooLarge", "Your proposed upload exceeds the maximum allowed object size.", 400)
IncompleteBody = APIError("IncompleteBody", "You did not provide the number of bytes specified by the Content-Length HTTP header.", 400)
InternalError = APIError("InternalError", "We encountered an internal error, please try again.", 500)
InvalidAccessKeyId = APIError("InvalidAccessKeyId", "The Access Key Id you provided does not exist in our records.", 403)
InvalidArgument = APIError("InvalidArgument", "Invalid Argument", 400)
InvalidBucketName = APIError("InvalidBucketName", "The specified bucket is not valid.", 400)
InvalidDigest = APIError("InvalidDigest", "The Content-Md5 you specified is not valid.", 400)
InvalidRange = APIError("InvalidRange", "The requested range is not satisfiable", 416)
NoSuchWebsiteConfiguration = APIError(
    "NoSuchWebsiteConfiguration",
    "The specified bucket does not have a website configuration", 404,
)
OwnershipControlsNotFoundError = APIError(
    "OwnershipControlsNotFoundError",
    "The bucket ownership controls were not found", 404,
)
InvalidTag = APIError(
    "InvalidTag", "The TagKey or TagValue you have provided is invalid", 400
)
InvalidCopyDest = APIError(
    "InvalidRequest",
    "This copy request is illegal because it is trying to copy an object "
    "to itself without changing the object's metadata, storage class, "
    "website redirect location or encryption attributes.",
    400,
)
MalformedXML = APIError("MalformedXML", "The XML you provided was not well-formed or did not validate against our published schema.", 400)
MissingContentLength = APIError("MissingContentLength", "You must provide the Content-Length HTTP header.", 411)
NoSuchBucket = APIError("NoSuchBucket", "The specified bucket does not exist", 404)
NoSuchKey = APIError("NoSuchKey", "The specified key does not exist.", 404)
NoSuchVersion = APIError("NoSuchVersion", "The specified version does not exist.", 404)
NoSuchUpload = APIError("NoSuchUpload", "The specified multipart upload does not exist. The upload ID may be invalid, or the upload may have been aborted or completed.", 404)
NotImplemented_ = APIError("NotImplemented", "A header you provided implies functionality that is not implemented", 501)
PreconditionFailed = APIError("PreconditionFailed", "At least one of the pre-conditions you specified did not hold", 412)
NotModified = APIError("NotModified", "Not Modified", 304)
SignatureDoesNotMatch = APIError("SignatureDoesNotMatch", "The request signature we calculated does not match the signature you provided. Check your key and signing method.", 403)
MethodNotAllowed = APIError("MethodNotAllowed", "The specified method is not allowed against this resource.", 405)
BucketNotEmpty = APIError("BucketNotEmpty", "The bucket you tried to delete is not empty", 409)
InvalidBucketState = APIError("InvalidBucketState", "The request is not valid with the current state of the bucket.", 409)
BucketAlreadyOwnedByYou = APIError("BucketAlreadyOwnedByYou", "Your previous request to create the named bucket succeeded and you already own it.", 409)
BucketAlreadyExists = APIError("BucketAlreadyExists", "The requested bucket name is not available. The bucket namespace is shared by all users of the system. Please select a different name and try again.", 409)
InvalidPart = APIError("InvalidPart", "One or more of the specified parts could not be found.  The part may not have been uploaded, or the specified entity tag may not match the part's entity tag.", 400)
InvalidPartOrder = APIError("InvalidPartOrder", "The list of parts was not in ascending order. The parts list must be specified in order by part number.", 400)
InvalidMaxKeys = APIError("InvalidMaxKeys", "Argument maxKeys must be an integer between 0 and 2147483647", 400)
AuthorizationHeaderMalformed = APIError("AuthorizationHeaderMalformed", "The authorization header is malformed; the region is wrong.", 400)
RequestTimeTooSkewed = APIError("RequestTimeTooSkewed", "The difference between the request time and the server's time is too large.", 403)
ExpiredPresignRequest = APIError("ExpiredPresignRequest", "Request has expired", 403)
MissingFields = APIError("MissingFields", "Missing fields in request.", 400)
AuthorizationQueryParametersError = APIError("AuthorizationQueryParametersError", "X-Amz-Expires must be between 1 and 604800 seconds", 400)
MalformedPolicy = APIError("MalformedPolicy", "Policy has invalid resource.", 400)
InvalidObjectState = APIError("InvalidObjectState", "The operation is not valid for the current state of the object.", 403)
XAmzContentSHA256Mismatch = APIError("XAmzContentSHA256Mismatch", "The provided 'x-amz-content-sha256' header does not match what was computed.", 400)
NoSuchBucketPolicy = APIError("NoSuchBucketPolicy", "The bucket policy does not exist", 404)
NoSuchTagSet = APIError("NoSuchTagSet", "The TagSet does not exist", 404)
NoSuchLifecycleConfiguration = APIError("NoSuchLifecycleConfiguration", "The lifecycle configuration does not exist", 404)
ObjectLockConfigurationNotFoundError = APIError("ObjectLockConfigurationNotFoundError", "Object Lock configuration does not exist for this bucket", 404)
ServerSideEncryptionConfigurationNotFoundError = APIError("ServerSideEncryptionConfigurationNotFoundError", "The server side encryption configuration was not found", 404)
NoSuchCORSConfiguration = APIError("NoSuchCORSConfiguration", "The CORS configuration does not exist", 404)
ReplicationConfigurationNotFoundError = APIError("ReplicationConfigurationNotFoundError", "The replication configuration was not found", 404)
NotificationNotFound = APIError("NoSuchConfiguration", "The specified configuration does not exist.", 404)
AdminBucketQuotaExceeded = APIError(
    "XMinioAdminBucketQuotaExceeded", "Bucket quota exceeded", 400
)
SlowDown = APIError(
    "SlowDown",
    "Resource requested is unreadable, please reduce your request rate",
    503,
)
